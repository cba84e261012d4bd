"""Bucketed policy-serving engine on one device.

The counterpart of ``repro.serve.engine``. A trained fleet policy becomes a
decision service: every request batch is padded host-side to the smallest
covering bucket and served by one launch of the fused inference kernel
(``dispatch.policy_infer``: obs-normalize -> policy MLP -> mean/sample).

Construction is the twin of the JAX engine's per-bucket AOT compile: the
kernel library is built and loaded, the weights and norm stats move to the
device once, and every bucket gets a pinned host obs/noise/action buffer and
a device obs/noise buffer, then one warm-up launch. The hot path
(:meth:`ServeEngine.decide`) never builds and never allocates on the device:
it fills the host buffers, makes one host-to-device copy of the obs (and of
the noise in ``mode="sample"``; the mean decision does not read it), launches
one kernel that writes the actions into the device noise buffer in place
(the twin of the JAX engine's donated noise buffer), makes one
device-to-host copy and slices the padding off. ``n_builds`` counts the
construction passes and stays 1.

The sample-mode noise comes from ``np.random.default_rng(seed)``, drawn as
``standard_normal((bucket, act_dim), float32)`` per call exactly as the JAX
engine draws it: that is the engine's replay contract, and it makes sampled
decisions comparable across the two packages.

``device="cuda"`` (the default) runs the hand-written kernel and raises
without a card; ``device="cpu"`` runs the plain PyTorch path.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import _build, dispatch
from repro_torch.rl.policy import params_to_numpy

DEFAULT_BUCKETS = (8, 64, 256, 1024)

MODES = ("mean", "sample")


@dataclasses.dataclass(frozen=True)
class ObsNorm:
    """Observation normalization stats: ``(obs - mean) / std``.

    ``std`` entries must be strictly positive (the identity norm is mean 0 /
    std 1). Stored fp32.
    """

    mean: np.ndarray
    std: np.ndarray

    def __post_init__(self):
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        if mean.ndim != 1 or mean.shape != std.shape:
            raise ValueError(
                f"ObsNorm: mean/std must be matching (obs_dim,) vectors, "
                f"got {mean.shape} vs {std.shape}"
            )
        if not np.all(std > 0.0):
            raise ValueError("ObsNorm: std must be strictly positive")
        object.__setattr__(self, "mean", mean)
        object.__setattr__(self, "std", std)

    @classmethod
    def identity(cls, obs_dim: int) -> "ObsNorm":
        return cls(np.zeros(obs_dim, np.float32), np.ones(obs_dim, np.float32))

    @classmethod
    def from_obs(cls, obs, eps: float = 1e-6) -> "ObsNorm":
        """Fit stats from an ``(..., obs_dim)`` observation buffer (array or
        tensor)."""
        if isinstance(obs, torch.Tensor):
            obs = obs.detach().cpu().numpy()
        o = np.asarray(obs, np.float32)
        flat = o.reshape(-1, o.shape[-1])
        return cls(flat.mean(axis=0), flat.std(axis=0) + eps)


def _policy_dims(pi) -> Tuple[int, int]:
    for name in ("w1", "w3"):
        if name not in pi:
            raise ValueError(
                f"serve: params['pi'] needs {name!r} (got {sorted(pi)})"
            )
    return int(pi["w1"].shape[0]), int(pi["w3"].shape[1])


def _host_tensor(v) -> torch.Tensor:
    """A leaf as a tensor; float64 arrays become float32, as ``jnp.asarray``
    makes them without x64."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    t = torch.tensor(np.asarray(v))
    return t.float() if t.dtype == torch.float64 else t


class _Bucket(NamedTuple):
    host_obs: np.ndarray       # (b, obs_dim) views of pinned host memory
    host_noise: np.ndarray     # (b, act_dim)
    host_act: np.ndarray       # (b, act_dim)
    dev_obs: torch.Tensor      # on the engine's device
    dev_noise: torch.Tensor    # receives the actions in place
    pinned: Tuple[torch.Tensor, ...]   # owners of the host views


class ServeEngine:
    """Bucketed policy-forward engine over a trained fleet policy.

    ``params`` is a :class:`repro_torch.rl.policy.GaussianMLPPolicy` or any
    tree with a matching ``"pi"`` head (tensors or arrays). ``mode`` picks
    the decision rule: ``"mean"`` (deterministic — the tanh policy mean) or
    ``"sample"`` (mean + exp(log_std) * noise, noise from a seeded host-side
    generator so a replayed request schedule reproduces its decisions).
    """

    def __init__(self, params, *, norm: Optional[ObsNorm] = None,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 mode: str = "mean", seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        if mode not in MODES:
            raise ValueError(f"unknown serve mode {mode!r}; expected {MODES}")
        if "pi" not in params:
            raise ValueError(
                f"serve: params must carry the policy head under 'pi', "
                f"got keys {sorted(params)}"
            )
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"serve: buckets must be positive ints, got {buckets}")
        self.mode = mode
        self.device = dispatch.resolve_device(device)
        self.buckets = buckets
        self.obs_dim, self.act_dim = _policy_dims(params["pi"])
        self.norm = norm if norm is not None else ObsNorm.identity(self.obs_dim)
        if self.norm.mean.shape != (self.obs_dim,):
            raise ValueError(
                f"serve: norm is for obs_dim {self.norm.mean.shape[0]}, "
                f"policy expects {self.obs_dim}"
            )
        self._pi = {
            k: _host_tensor(v).to(self.device, copy=True)
            for k, v in params["pi"].items()
        }
        self._nm = torch.tensor(self.norm.mean, device=self.device)
        self._ns = torch.tensor(self.norm.std, device=self.device)
        self._rng = np.random.default_rng(seed)
        self.n_decisions = 0
        self.n_padded = 0
        self.n_builds = 0
        self.bucket_calls: Dict[int, int] = {b: 0 for b in buckets}
        self._bufs = self._build()

    def _build(self) -> Dict[int, _Bucket]:
        """Build the kernel, allocate every bucket's buffers and launch each
        bucket once: the twin of one AOT compile per bucket."""
        on_card = self.device.type == "cuda"
        if on_card:
            _build.load()
        bufs = {}
        for b in self.buckets:
            host = [
                torch.zeros(shape, dtype=torch.float32, pin_memory=on_card)
                for shape in ((b, self.obs_dim), (b, self.act_dim),
                              (b, self.act_dim))
            ]
            if on_card:
                dev_obs = torch.zeros_like(host[0], device=self.device)
                dev_noise = torch.zeros_like(host[1], device=self.device)
            else:
                dev_obs, dev_noise = host[0], host[1]
            bufs[b] = _Bucket(*(t.numpy() for t in host), dev_obs, dev_noise,
                              tuple(host))
            self._launch(bufs[b])
        if on_card:
            torch.cuda.current_stream(self.device).synchronize()
        self.n_builds += 1
        return bufs

    def _launch(self, buf: _Bucket) -> None:
        dispatch.policy_infer(
            buf.dev_obs, self._pi, self._nm, self._ns, buf.dev_noise,
            sample=self.mode == "sample", out=buf.dev_noise,
        )

    # --- checkpoint seam -------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, step: Optional[int] = None,
                        **kwargs) -> "ServeEngine":
        """Restore a serving engine through ``repro_torch.checkpoint.restore``.

        Accepts either a :func:`save_for_serving` checkpoint (``{"params":
        ..., "obs_norm": {"mean", "std"}}``) or a bare policy tree with a
        ``"pi"`` head, written by either package. An explicit ``norm=`` kwarg
        overrides the stored one.
        """
        from repro_torch.checkpoint import restore

        tree, _meta = restore(ckpt_dir, step)
        if "params" in tree:
            params = tree["params"]
            if "norm" not in kwargs and "obs_norm" in tree:
                kwargs["norm"] = ObsNorm(
                    tree["obs_norm"]["mean"], tree["obs_norm"]["std"]
                )
        elif "pi" in tree:
            params = tree
        else:
            raise ValueError(
                f"serve: checkpoint carries neither 'params' nor 'pi' "
                f"(got keys {sorted(tree)})"
            )
        return cls(params, **kwargs)

    def load_params(self, params) -> None:
        """Hot-swap policy weights in place (same shapes and dtypes): no
        rebuild, no new device buffers."""
        if "pi" not in params:
            raise ValueError("serve: params must carry the policy head under 'pi'")
        new = {k: _host_tensor(v) for k, v in params["pi"].items()}
        for k, v in self._pi.items():
            if k not in new or new[k].shape != v.shape or new[k].dtype != v.dtype:
                raise ValueError(
                    f"serve: hot-swap params differ in structure at 'pi.{k}' "
                    f"— build a new engine instead"
                )
        for k, v in self._pi.items():
            v.copy_(new[k])

    # --- hot path --------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering ``n`` (the largest bucket caps ``n``)."""
        if n < 1:
            raise ValueError(f"serve: batch must be >= 1, got {n}")
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[min(i, len(self.buckets) - 1)]

    def max_batch(self) -> int:
        return self.buckets[-1]

    def decide(self, obs) -> np.ndarray:
        """Decisions for an ``(n, obs_dim)`` observation batch, ``n`` <= the
        largest bucket. Pads to the covering bucket, launches the kernel once
        and slices the padding back off — padded rows never change a real
        row's decision (rows are independent). Returns host ``(n, act_dim)``
        float32 actions."""
        obs = np.asarray(obs, np.float32)
        if obs.ndim != 2 or obs.shape[1] != self.obs_dim:
            raise ValueError(
                f"serve: obs must be (n, {self.obs_dim}), got {obs.shape}"
            )
        n = obs.shape[0]
        if n > self.buckets[-1]:
            raise ValueError(
                f"serve: batch of {n} exceeds the largest bucket "
                f"{self.buckets[-1]}; split it (the queue does this)"
            )
        b = self.bucket_for(n)
        buf = self._bufs[b]
        buf.host_obs[:n] = obs
        buf.host_obs[n:] = 0.0
        sample = self.mode == "sample"
        if sample:
            self._rng.standard_normal(dtype=np.float32, out=buf.host_noise)
        if self.device.type == "cuda":
            buf.dev_obs.copy_(buf.pinned[0], non_blocking=True)
            if sample:
                buf.dev_noise.copy_(buf.pinned[1], non_blocking=True)
            self._launch(buf)
            buf.pinned[2].copy_(buf.dev_noise, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            act = buf.host_act
        else:
            self._launch(buf)
            act = buf.host_noise      # the plain path wrote the actions here
        self.n_decisions += n
        self.n_padded += b - n
        self.bucket_calls[b] += 1
        return act[:n].copy()


def save_for_serving(ckpt_dir: str, step: int, params,
                     norm: Optional[ObsNorm] = None,
                     metadata: Optional[dict] = None) -> str:
    """Write a serving checkpoint (``repro_torch.checkpoint.save`` format).

    The tree layout is what :meth:`ServeEngine.from_checkpoint` of either
    package reads back: ``{"params": <policy tree>, "obs_norm": {"mean",
    "std"}}``.
    """
    from repro_torch.checkpoint import save

    if "pi" not in params:
        raise ValueError("serve: params must carry the policy head under 'pi'")
    obs_dim, _ = _policy_dims(params["pi"])
    norm = norm if norm is not None else ObsNorm.identity(obs_dim)
    if isinstance(params, nn.Module):
        params = params_to_numpy(params)
    tree = {
        "params": params,
        "obs_norm": {"mean": norm.mean, "std": norm.std},
    }
    meta = dict(metadata or {})
    meta.setdefault("kind", "serve")
    return save(ckpt_dir, step, tree, metadata=meta)
