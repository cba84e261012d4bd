"""Device dispatch for the port's primitives.

The counterpart of ``repro.kernels.dispatch``. Where the JAX package picks a
backend (``jnp`` / ``interpret`` / ``pallas``, with ``auto`` resolving by
platform), the port picks by the device the tensors lie on:

* on CPU tensors a primitive runs its plain PyTorch version;
* on CUDA tensors it launches its hand-written kernel, or raises. A kernel
  error is never caught and retried on the plain path.

Entry points take ``device=`` and run on the card unless the caller asks for
the CPU; :func:`resolve_device` raises when the card is asked for and there
is none. There is no ``auto`` that drops to the CPU.

The flat ``(m, n)`` primitives of the federated hot path (m agents by n
parameters; ``decay_accum``, ``scale_rows``, ``row_mean``,
``flat_opt_update``, the gossip mixes ``consensus_mix`` and
``consensus_gather`` and the compressed reduction ``topk_scatter``) raise
the validation errors of the JAX dispatch. Every one computes in fp32 and
casts back to the buffer's dtype, as ``repro.kernels.dispatch`` does (its
lines 32-35).

Sweep shapes: every flat primitive also takes a leading run axis S,
``(S, m, n)`` buffers for S independent runs, with JAX's coefficient forms
(a scalar, a shared ``(m,)``, a per-run ``(S,)`` or ``(S, m)``, shared or
per-run ``(S, m, m)`` mixing, shared or per-run ``(S, m, k_max)`` edge
weights) and JAX's refusal of a 1-D coefficient when S == m. One call is one
launch on the card whatever S: the elementwise primitives and the gather
fold the runs into S * m rows, and ``row_mean``, ``consensus_mix`` and
``topk_scatter`` launch their kernels with the run in the grid. Each run's
result is bitwise what the same primitive gives on that run's ``(m, n)``
slice; the plain versions on the CPU compute run by run.

The language models' recurrence ``wkv6`` and their full-sequence attention
``swa_attention`` route the same way: the plain version on CPU tensors, the
hand-written kernel on CUDA tensors.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.consensus_gather import (
    consensus_gather_cuda,
    consensus_gather_plain,
)
from repro_torch.kernels.consensus_step import (
    consensus_step_cuda,
    consensus_step_plain,
)
from repro_torch.kernels.decay_accum import decay_accum_cuda, decay_accum_plain
from repro_torch.kernels.flat_update import (
    adam_update_cuda,
    adam_update_plain,
    momentum_update_cuda,
    momentum_update_plain,
    row_mean_cuda,
    row_mean_plain,
)
from repro_torch.kernels.policy_infer import (
    PI_KEYS,
    policy_infer_cuda,
    policy_infer_plain,
)
from repro_torch.kernels.swa_attention import (
    swa_attention_cuda,
    swa_attention_plain,
)
from repro_torch.kernels.topk_scatter import (
    topk_scatter_cuda,
    topk_scatter_plain,
)
from repro_torch.kernels.wkv6 import (
    check_shapes as check_wkv6_shapes,
    wkv6_cuda,
    wkv6_plain,
)

OPT_KINDS = ("sgd", "momentum", "adam")


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` requires a card.

    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false, and ``ValueError`` for a device
    type the port does not run on.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"repro_torch: device {str(device)!r} asked for, but CUDA is "
                f"not available; pass device='cpu' to run the plain PyTorch "
                f"path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch: unsupported device {str(device)!r}; "
                         f"expected 'cuda' or 'cpu'")
    return dev


def policy_infer(obs: torch.Tensor, pi: Mapping[str, torch.Tensor],
                 norm_mean, norm_std, noise: torch.Tensor, *,
                 sample: bool = False,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused serving inference: obs-normalize -> policy MLP -> mean/sample.

    ``obs`` is a ``(B, obs_dim)`` observation batch, ``pi`` the Gaussian
    policy head (``w1, b1, w2, b2, w3, b3, log_std``, weights ``(in, out)``),
    ``norm_mean``/``norm_std`` the ``(obs_dim,)`` normalization stats (cast
    to fp32, as the JAX dispatch does) and ``noise`` a ``(B, act_dim)``
    standard-normal operand. Returns the ``(B, act_dim)`` actions in
    ``obs.dtype``: the tanh policy mean, or ``mean + exp(log_std) * noise``
    with ``sample=True``. ``out`` (may be ``noise``) receives the actions.

    Raises the validation errors of ``repro.kernels.dispatch.policy_infer``.
    """
    if obs.ndim != 2:
        raise ValueError(f"policy_infer: obs must be (B, obs_dim), got "
                         f"{tuple(obs.shape)}")
    for name in PI_KEYS:
        if name not in pi:
            raise ValueError(f"policy_infer: pi needs {name!r} (got {sorted(pi)})")
    B, obs_dim = obs.shape
    act_dim = pi["w3"].shape[1]
    if pi["w1"].shape[0] != obs_dim:
        raise ValueError(
            f"policy_infer: w1 expects obs_dim {pi['w1'].shape[0]}, "
            f"obs has {obs_dim}"
        )
    if tuple(noise.shape) != (B, act_dim):
        raise ValueError(
            f"policy_infer: noise must be ({B}, {act_dim}), got "
            f"{tuple(noise.shape)}"
        )
    nm = torch.as_tensor(norm_mean, dtype=torch.float32, device=obs.device)
    ns = torch.as_tensor(norm_std, dtype=torch.float32, device=obs.device)
    if tuple(nm.shape) != (obs_dim,) or tuple(ns.shape) != (obs_dim,):
        raise ValueError(
            f"policy_infer: norm stats must be ({obs_dim},), got "
            f"{tuple(nm.shape)} / {tuple(ns.shape)}"
        )
    if obs.device.type == "cpu":
        return policy_infer_plain(obs, pi, nm, ns, noise, sample=sample, out=out)
    if obs.device.type == "cuda":
        return policy_infer_cuda(obs, pi, nm, ns, noise, sample=sample, out=out)
    raise ValueError(f"policy_infer: unsupported device {obs.device}")


# --- flat <-> parameter-tree plumbing -------------------------------------------

def _leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """``(path, leaf)`` pairs in ``jax.flatten_util.ravel_pytree``'s order:
    mapping keys sorted at every level."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    keys = sorted(tree.keys()) if hasattr(tree, "keys") else sorted(tree)
    out = []
    for k in keys:
        out += _leaves(tree[k], prefix + (k,))
    return out


class FlatSpec:
    """Where each leaf of one replica's parameter tree lies in a flat row.

    The row order is ``ravel_pytree``'s (sorted keys), so flat rows and the
    JAX package's flat rows hold the same numbers at the same places.
    :meth:`unravel` maps an ``(m, n)`` matrix to the stacked tree and
    :meth:`unravel_one` an ``(n,)`` row to one replica's tree; both return
    views of the buffer, not copies. :meth:`ravel_one` is the inverse of
    :meth:`unravel_one`.
    """

    def __init__(self, paths, shapes):
        self.paths = tuple(paths)
        self.shapes = tuple(tuple(s) for s in shapes)
        self.sizes = tuple(int(np.prod(s, dtype=np.int64)) for s in self.shapes)
        self.offsets = tuple(int(o) for o in np.cumsum((0,) + self.sizes)[:-1])
        self.n = int(sum(self.sizes))

    def _nest(self, views) -> Dict:
        tree: Dict = {}
        for path, v in zip(self.paths, views):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
        return tree

    def unravel(self, flat: torch.Tensor) -> Dict:
        m = flat.shape[0]
        return self._nest(flat[:, o:o + s].view(m, *shape) for o, s, shape
                          in zip(self.offsets, self.sizes, self.shapes))

    def unravel_one(self, row: torch.Tensor) -> Dict:
        return self._nest(row[o:o + s].view(shape) for o, s, shape
                          in zip(self.offsets, self.sizes, self.shapes))

    def ravel_one(self, tree) -> torch.Tensor:
        return torch.cat([leaf.reshape(-1) for _, leaf in _leaves(tree)])


def stacked_ravel_spec(tree_m) -> Tuple[torch.Tensor, FlatSpec]:
    """Flatten an ``(m, ...)``-leaved replica tree to ``(flat, FlatSpec)``:
    ``flat`` is a new contiguous ``(m, n)`` matrix."""
    leaves = _leaves(tree_m)
    if not leaves:
        raise ValueError("stacked_ravel: empty pytree")
    m = leaves[0][1].shape[0]
    for _, leaf in leaves:
        if leaf.ndim < 1 or leaf.shape[0] != m:
            raise ValueError(
                f"stacked_ravel: every leaf needs leading agent axis {m}, "
                f"got shape {tuple(leaf.shape)}"
            )
    spec = FlatSpec([p for p, _ in leaves],
                    [tuple(leaf.shape[1:]) for _, leaf in leaves])
    flat = torch.cat([leaf.reshape(m, -1) for _, leaf in leaves], dim=1)
    return flat.contiguous(), spec


def compute_view(buf: torch.Tensor, storage_dtype) -> torch.Tensor:
    """fp32 compute view of a flat carry buffer: ``buf.float()`` when a
    reduced storage dtype is set (the bf16 buffer mode), else ``buf``."""
    return buf.float() if storage_dtype is not None else buf


# --- flat (m, n) primitives -------------------------------------------------------

def _f32(c, device):
    """A coefficient as the dispatch takes it: numbers stay numbers; arrays
    and tensors become fp32 tensors on ``device``."""
    if isinstance(c, (int, float)):
        return float(c)
    return torch.as_tensor(c, dtype=torch.float32, device=device)


def _is_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _ndim(c) -> int:
    return c.ndim if isinstance(c, torch.Tensor) else 0


def _shape(c) -> tuple:
    return tuple(np.shape(c)) if not isinstance(c, torch.Tensor) else \
        tuple(c.shape)


def _per_row(fn: str, what: str, c, S: int, m: int, *, per_run_1d: bool):
    """A coefficient of an ``(S, m, n)`` call as one value per row: a number
    or 0-d tensor stays as it is; a shared ``(m,)`` vector is tiled over the
    runs, a per-run ``(S,)`` one (where ``per_run_1d``) repeated over each
    run's agents, and ``(S, m)`` taken as it is — a contiguous ``(S, m)``
    tensor. A 1-D coefficient when S == m is refused, as the JAX dispatch
    refuses it (the two readings disagree)."""
    nd = _ndim(c)
    if nd == 0:
        return c
    if nd == 1 and S == m and c.shape[0] == S:
        if per_run_1d:
            raise ValueError(
                f"{fn}: 1-D {what} of length {S} is ambiguous on a sweep "
                f"path with S == m == {S}; pass (S, m) coefficients (tile "
                f"the shared/per-run vector) or a scalar")
        raise ValueError(
            f"{fn}: 1-D {what} of length {m} is ambiguous on a sweep path "
            f"with S == m == {S}; pass (S, m) weights")
    if nd == 1 and per_run_1d and c.shape[0] == S:
        return c[:, None].expand(S, m).contiguous()
    if nd == 1 and c.shape[0] == m:
        return c[None, :].expand(S, m).contiguous()
    if nd == 2 and tuple(c.shape) == (S, m):
        return c.contiguous()
    raise ValueError(
        f"{fn}: {what} must be a scalar, ({m},) shared"
        + (f", ({S},) per run" if per_run_1d else "")
        + f" or ({S}, {m}) per row on a sweep path with buffers "
        f"({S}, {m}, n), got {what} shape {tuple(c.shape)}")


def _fold(t: torch.Tensor) -> torch.Tensor:
    """An ``(S, m, n)`` buffer as its ``(S * m, n)`` rows (a view)."""
    return t.reshape(t.shape[0] * t.shape[1], t.shape[2])


def decay_accum(acc: torch.Tensor, g: torch.Tensor, d, *,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + d * g`` — the fused FMA at the heart of the decay/SGD step.

    ``acc``/``g``: matching ``(n,)`` or ``(m, n)`` buffers of one dtype, or
    ``(S, m, n)`` for S runs; ``d``: a scalar, or ``(m,)`` per-agent
    coefficients with ``(m, n)`` buffers; on ``(S, m, n)`` also ``(m,)``
    shared, ``(S,)`` per run or ``(S, m)`` per row. Accumulates in fp32;
    the result has ``acc.dtype``. ``out`` (may be ``acc``) receives the
    result.
    """
    if acc.ndim == 3:
        if acc.shape != g.shape:
            raise ValueError(
                f"decay_accum: acc/g must match on the sweep path, got "
                f"{tuple(acc.shape)} vs {tuple(g.shape)}")
        if acc.dtype != g.dtype:
            raise ValueError(
                f"decay_accum: acc/g dtypes must match, got {acc.dtype} vs "
                f"{g.dtype}")
        S, m = acc.shape[0], acc.shape[1]
        d = _per_row("decay_accum", "d", _f32(d, acc.device), S, m,
                     per_run_1d=True)
        if _is_cuda(acc):
            return decay_accum_cuda(acc, g, d, out=out)
        return decay_accum_plain(acc, g, d, out=out)
    if acc.ndim not in (1, 2) or acc.shape != g.shape:
        raise ValueError(
            f"decay_accum: acc/g must be matching (n,) or (m, n) buffers, "
            f"got {tuple(acc.shape)} vs {tuple(g.shape)}"
        )
    if acc.dtype != g.dtype:
        raise ValueError(
            f"decay_accum: acc/g dtypes must match, got {acc.dtype} vs "
            f"{g.dtype}"
        )
    d = _f32(d, acc.device)
    if _ndim(d) not in (0, 1) or (_ndim(d) == 1 and (
            acc.ndim != 2 or d.shape[0] != acc.shape[0])):
        raise ValueError(
            f"decay_accum: d must be scalar or (m,) with (m, n) inputs, "
            f"got d shape {_shape(d)} for input shape "
            f"{tuple(acc.shape)}"
        )
    if _is_cuda(acc):
        return decay_accum_cuda(acc, g, d, out=out)
    return decay_accum_plain(acc, g, d, out=out)


def scale_rows(g: torch.Tensor, w, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-scale ``(m, n)`` grads by per-agent weights: ``out[i] = w[i]*g[i]``.

    On the card this is ``decay_accum(g, g, w - 1)`` = ``g + (w - 1) * g``,
    as on the JAX kernel path; the CPU path computes ``w * g`` as the jnp
    path does. ``(S, m, n)`` grads take shared ``(m,)`` or per-run
    ``(S, m)`` weights.
    """
    if g.ndim == 3:
        S, m = g.shape[0], g.shape[1]
        w = torch.as_tensor(w, dtype=torch.float32, device=g.device)
        if w.ndim not in (1, 2):
            raise ValueError(
                f"scale_rows: w must be ({m},) shared or ({S}, {m}) per run, "
                f"got {tuple(w.shape)}")
        w = _per_row("scale_rows", "w", w, S, m, per_run_1d=False)
        if _is_cuda(g):
            return decay_accum_cuda(g, g, w - 1.0, out=out)
        res = (g.float() * w[..., None]).to(g.dtype)
        return res if out is None else out.copy_(res)
    if g.ndim != 2:
        raise ValueError(f"scale_rows: g must be (m, n), got {tuple(g.shape)}")
    w = torch.as_tensor(w, dtype=torch.float32, device=g.device)
    if tuple(w.shape) != (g.shape[0],):
        raise ValueError(
            f"scale_rows: w must be ({g.shape[0]},) for g {tuple(g.shape)}, "
            f"got {tuple(w.shape)}"
        )
    if _is_cuda(g):
        return decay_accum_cuda(g, g, w - 1.0, out=out)
    res = (g.float() * w[:, None]).to(g.dtype)
    return res if out is None else out.copy_(res)


def row_mean(g: torch.Tensor, *,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Server averaging (eq. 11) on the flat carry: the ``(n,)`` mean over the
    agent axis of ``(m, n)`` buffers (``(S, n)`` for ``(S, m, n)``),
    accumulated in fp32, in ``g.dtype``."""
    if g.ndim not in (2, 3):
        raise ValueError(f"row_mean: g must be (m, n), got {tuple(g.shape)}")
    if _is_cuda(g):
        return row_mean_cuda(g, out=out)
    return row_mean_plain(g, out=out)


def consensus_mix(g: torch.Tensor, mixing, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One (possibly fused-E, possibly mask-folded) gossip mix: ``mixing @ g``.

    ``g``: ``(m, n)`` flat grads, or ``(S, m, n)``; ``mixing``: ``(m, m)``
    (shared by the runs), or ``(S, m, m)`` per run; cast to fp32 on ``g``'s
    device. Accumulates in fp32 (no TF32) and casts back to ``g.dtype``.
    ``out`` receives the result and must not be ``g``.
    """
    if g.ndim not in (2, 3):
        raise ValueError(f"consensus_mix: g must be (m, n), got "
                         f"{tuple(g.shape)}")
    m = g.shape[-2]
    mixing = torch.as_tensor(mixing, device=g.device)
    if g.ndim == 3 and mixing.ndim == 3:
        if tuple(mixing.shape) != (g.shape[0], m, m):
            raise ValueError(
                f"consensus_mix: per-run mixing must be ({g.shape[0]}, {m}, "
                f"{m}) for g {tuple(g.shape)}, got {tuple(mixing.shape)}")
    elif tuple(mixing.shape) != (m, m):
        raise ValueError(
            f"consensus_mix: mixing must be ({m}, {m}) for g "
            f"{tuple(g.shape[-2:])}, got {tuple(mixing.shape)}"
        )
    mixing = mixing.to(torch.float32).contiguous()
    if _is_cuda(g):
        return consensus_step_cuda(g, mixing, out=out)
    return consensus_step_plain(g, mixing, out=out)


def consensus_gather(g: torch.Tensor, idx, w, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sparse neighbor-list gossip round: ``out[i] = sum_k w[i,k] *
    g[idx[i,k]]``.

    ``g``: ``(m, n)`` flat grads (or ``(S, m, n)``); ``idx``: ``(m, k_max)``
    integer neighbor ids in the ``NeighborList`` layout (ascending valid
    prefix, self included, padding = own row), shared by the runs; ``w``:
    ``(m, k_max)`` edge weights, 0.0 on padding (or ``(S, m, k_max)`` per
    run). The sum is the sequential fp32 chain in ascending k on both
    paths, cast back to ``g.dtype``; the runs fold into S * m rows whose
    ids point into their own run. An ``idx`` handed over on the host (numpy
    or a CPU tensor) is range-checked before it moves to the card; a CUDA
    ``idx`` is taken as it is (checked once, when it was built). ``out``
    receives the result and must not be ``g``.
    """
    on_host = not (isinstance(idx, torch.Tensor) and idx.device.type == "cuda")
    idx = torch.as_tensor(idx)
    if idx.ndim != 2 or idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise ValueError(
            f"consensus_gather: idx must be an (m, k_max) integer array, got "
            f"shape {tuple(idx.shape)} dtype {idx.dtype}"
        )
    if g.ndim not in (2, 3):
        raise ValueError(f"consensus_gather: g must be (m, n), got "
                         f"{tuple(g.shape)}")
    m = g.shape[-2]
    if idx.shape[0] != m:
        raise ValueError(
            f"consensus_gather: idx must be ({m}, k_max) for g "
            f"{tuple(g.shape[-2:])}, got {tuple(idx.shape)}"
        )
    w = torch.as_tensor(w, dtype=torch.float32, device=g.device)
    per_run = g.ndim == 3 and w.ndim == 3
    want = (g.shape[0],) + tuple(idx.shape) if per_run else tuple(idx.shape)
    if tuple(w.shape) != want:
        raise ValueError(
            f"consensus_gather: w must match idx {tuple(idx.shape)}, got "
            f"{tuple(w.shape)}"
        )
    if on_host and idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= m):
        raise ValueError(f"consensus_gather: idx rows must lie in [0, {m})")
    if g.ndim == 3:
        S, k = g.shape[0], idx.shape[1]
        idx = (idx.to(g.device, torch.int64)[None]
               + m * torch.arange(S, device=g.device)[:, None, None])
        idx = idx.reshape(S * m, k)
        w = (w if per_run else w[None].expand(S, m, k)).reshape(S * m, k)
        res = consensus_gather(_fold(g), idx, w,
                               out=None if out is None else _fold(out))
        return res.view(g.shape) if out is None else out
    if _is_cuda(g):
        idx = idx.to(device=g.device, dtype=torch.int32).contiguous()
        return consensus_gather_cuda(g, idx, w.contiguous(), out=out)
    return consensus_gather_plain(g, idx, w, out=out)


def topk_scatter(x: torch.Tensor, thresh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k select + scatter-accumulate: the compressed server
    reduction.

    ``x``: ``(m, n)`` payload rows; ``thresh``: ``(m,)`` per-agent magnitude
    thresholds (normally ``repro_torch.comm.topk_threshold(x, k)``); on a
    sweep ``(S, m, n)`` with ``(S, m)``. Selection keeps ``|x| >= thresh``
    with ties included. Returns ``(sent_sum, residual)``: the ``(n,)``
    (``(S, n)``) fp32 sum of the selected entries over agents, cast to
    ``x.dtype``, and the unselected remainder (``sent + residual == x``
    exactly).
    """
    if x.ndim == 3:
        thresh = torch.as_tensor(thresh, dtype=torch.float32, device=x.device)
        if tuple(thresh.shape) != tuple(x.shape[:2]):
            raise ValueError(
                f"topk_scatter: thresh must be {tuple(x.shape[:2])} on the "
                f"sweep path, got {tuple(thresh.shape)}")
    elif x.ndim != 2:
        raise ValueError(f"topk_scatter: x must be (m, n), got "
                         f"{tuple(x.shape)}")
    else:
        m = x.shape[0]
        thresh = torch.as_tensor(thresh, dtype=torch.float32, device=x.device)
        if tuple(thresh.shape) != (m,):
            raise ValueError(
                f"topk_scatter: thresh must be ({m},) for x {tuple(x.shape)}, "
                f"got {tuple(thresh.shape)}"
            )
    if _is_cuda(x):
        return topk_scatter_cuda(x, thresh.contiguous())
    return topk_scatter_plain(x, thresh)


def _check_opt_state(state, required, params, kind):
    for name in required:
        buf = state.get(name)
        if buf is None:
            raise ValueError(f"flat_opt_update[{kind}]: state needs {name!r}")
        if name == "t":
            continue
        if buf.shape != params.shape:
            raise ValueError(
                f"flat_opt_update[{kind}]: state[{name!r}] shape "
                f"{tuple(buf.shape)} must match params {tuple(params.shape)}"
            )
        if buf.dtype != torch.float32:
            raise ValueError(
                f"flat_opt_update[{kind}]: state[{name!r}] must be an fp32 "
                f"accumulator, got {buf.dtype}"
            )


def adam_bias_corrections(t: int, b1: float, b2: float) -> Tuple[float, float]:
    """``(1 - b1**t, 1 - b2**t)`` computed in fp32, as the jnp path does
    (``dispatch.py:677-680``); ``t`` is the step count after this step."""
    tf = np.float32(t)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** tf), float(one - np.float32(b2) ** tf))


def flat_opt_update(params: torch.Tensor, g: torch.Tensor, w, state: dict, *,
                    kind: str, lr, beta: float = 0.9,
                    nesterov: bool = False, b1: float = 0.9, b2: float = 0.95,
                    eps: float = 1e-8, weight_decay: float = 0.0,
                    inplace: bool = False):
    """Fused within-period-weighted optimizer update on flat buffers.

    ``params``/``g``: matching ``(n,)`` or ``(m, n)`` buffers, or
    ``(S, m, n)`` for S runs. ``w`` is the strategy's per-step weight
    (variation mask x decay; scalar or ``(m,)``, and on ``(S, m, n)`` also
    ``(S,)`` per run or ``(S, m)`` per row, with ``decay_accum``'s S == m
    refusal), folded into the gradient before any moment accumulation.
    ``lr`` is a number, or on ``(S, m, n)`` one rate per run ``(S,)``.
    ``state`` holds the fp32 accumulators (see ``repro_torch.optim.flat``):

      * ``sgd``      — ``{}``; the fused :func:`decay_accum` pass with
                       ``d = -lr * w``;
      * ``momentum`` — ``{"mu"}``; mu <- beta*mu + w*g, params -= lr*mu
                       (nesterov: params -= lr*(beta*mu_new + w*g));
      * ``adam``     — ``{"mu", "nu", "t"}``; bias-corrected Adam(W), ``t`` a
                       host integer shared by the runs.

    Returns ``(new_params, new_state)``. With ``inplace=True`` the parameter
    buffer and the moment buffers are overwritten and returned (the training
    loop's carry); otherwise new tensors are returned.
    """
    if kind not in OPT_KINDS:
        raise ValueError(f"unknown optimizer kind {kind!r}; expected {OPT_KINDS}")
    sweep = params.ndim == 3
    if (params.ndim not in (1, 2) and not sweep) or params.shape != g.shape:
        raise ValueError(
            f"flat_opt_update: params/g must be matching (n,) or (m, n) "
            f"buffers, got {tuple(params.shape)} vs {tuple(g.shape)}"
        )
    w = _f32(w, params.device)
    if sweep:
        S, m = params.shape[0], params.shape[1]
        w = _per_row("flat_opt_update", "w", w, S, m, per_run_1d=True)
        if not isinstance(lr, (int, float)):
            lr = torch.as_tensor(lr, dtype=torch.float32,
                                 device=params.device)
            if lr.ndim == 0:
                lr = float(lr)
            elif tuple(lr.shape) != (S,):
                raise ValueError(
                    f"flat_opt_update: lr must be a scalar or ({S},) per run "
                    f"on a sweep path, got {tuple(lr.shape)}")
    elif _ndim(w) not in (0, 1) or (_ndim(w) == 1 and (
            params.ndim != 2 or w.shape[0] != params.shape[0])):
        raise ValueError(
            f"flat_opt_update: w must be scalar or (m,) with (m, n) inputs, "
            f"got w shape {_shape(w)} for input shape "
            f"{tuple(params.shape)}"
        )
    cuda = _is_cuda(params)
    p_out = params if inplace else None

    if kind == "sgd":
        if isinstance(lr, torch.Tensor):          # per run: (S, 1) * w
            d = (-lr[:, None] * w).expand(params.shape[:2]).contiguous()
        elif isinstance(w, float):
            d = float(np.float32(-lr) * np.float32(w))
        else:
            d = -lr * w
        return decay_accum(params, g, d, out=p_out), state

    if kind == "momentum":
        _check_opt_state(state, ("mu",), params, kind)
        mu = state["mu"]
        step = momentum_update_cuda if cuda else momentum_update_plain
        new_p, new_mu = step(params, g, mu, w, lr, beta, nesterov=nesterov,
                             p_out=p_out, mu_out=mu if inplace else None)
        return new_p, dict(state, mu=new_mu)

    _check_opt_state(state, ("mu", "nu", "t"), params, kind)
    mu, nu = state["mu"], state["nu"]
    t = int(state["t"]) + 1
    bc1, bc2 = adam_bias_corrections(t, b1, b2)
    step = adam_update_cuda if cuda else adam_update_plain
    new_p, new_mu, new_nu = step(
        params, g, mu, nu, w, lr, bc1, bc2, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, p_out=p_out,
        mu_out=mu if inplace else None, nu_out=nu if inplace else None,
    )
    return new_p, dict(state, mu=new_mu, nu=new_nu, t=t)


# --- language-model primitives ------------------------------------------------------

def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor, *,
         state_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence: ``(y, final_state)``.

    ``r, k, v, w``: ``(B, T, H, D)``; ``u``: ``(H, D)``; ``state``:
    ``(B, H, D, D)`` keyed ``[key, value]``. The time-mix hands them over in
    fp32, as the TPU kernel takes them. The final state goes to
    ``state_out`` when given (it may be ``state``: the in-place update),
    else to a new tensor. CPU tensors run the plain loop; CUDA tensors launch
    the kernel, which takes fp32 and D = 64 only and raises on anything else.
    """
    if _is_cuda(r):
        return wkv6_cuda(r, k, v, w, u, state, state_out=state_out)
    check_wkv6_shapes("wkv6", r, k, v, w, u, state)
    y, s = wkv6_plain(r, k, v, w, u, state)
    if state_out is None:
        return y, s
    return y, state_out.copy_(s)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int] = None, causal: bool = True
                  ) -> torch.Tensor:
    """Causal attention with an optional sliding window: ``o (B, Sq, H, D)``.

    ``q``: ``(B, Sq, H, D)``; ``k``, ``v``: ``(B, Sk, KV, D)``, not repeated
    (head h reads KV head ``h // (H // KV)``); positions of q and k both
    start at 0. CPU tensors run the plain version (any float dtype and head
    size); CUDA tensors launch the kernel, which takes fp32 or bf16 and head
    sizes 120 and 128 and raises on anything else.
    """
    if _is_cuda(q):
        return swa_attention_cuda(q, k, v, window=window, causal=causal)
    return swa_attention_plain(q, k, v, window=window, causal=causal)
