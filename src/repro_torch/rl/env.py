"""Ring-road traffic MARL environments (``repro.rl.env``) in PyTorch.

The counterpart of the JAX package's jit-able SUMO analogs:

* FIGURE_EIGHT — 14 vehicles on a closed loop with an intersection-like slow
  zone; 7 RL-controlled (every other vehicle). Background vehicles follow
  IDM; RL vehicles control acceleration in [-1, 1] to maximize the team's
  normalized average speed (NAS).
* MERGE — 50 vehicles on a longer ring with a slow zone emulating merge
  friction; 5 RL-controlled.

Collisions (gap < min_gap) force a brake-slam and flip the team reward to
``-crash_penalty`` for the rest of the episode.

Batching. ``EnvConfig`` holds the static structure; the dynamics live in
:class:`EnvParams`, a tuple of fp32 tensors. Where the JAX package vmaps the
single-env functions, every function here takes a batch directly: an
:class:`EnvState` has leaves shaped ``S + (N,)`` (positions, speeds) and
``S`` (the crash latch) for any leading batch shape ``S`` (``()`` for one
env, ``(m, B)`` for a fleet), and the parameter leaves broadcast against
``S`` (shape ``S``, a prefix-aligned shape such as ``(m, 1)`` for an
``(m, B)`` fleet, or scalars). The random draws are operands: the reset
jitter of :func:`env_reset` and the uniforms of :func:`perturb_params`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Union

import torch

OBS_DIM = 6


class EnvParams(NamedTuple):
    """Dynamic environment parameters: fp32 tensors, scalars or stacked
    ``(m,)`` / ``(m, B)`` per-agent values. Everything the physics reads."""

    length: torch.Tensor        # ring circumference (m)
    dt: torch.Tensor
    v_max: torch.Tensor
    a_max: torch.Tensor         # RL acceleration scale (m/s^2)
    min_gap: torch.Tensor       # collision threshold (m)
    crash_penalty: torch.Tensor
    # IDM params for background vehicles
    idm_v0: torch.Tensor
    idm_T: torch.Tensor
    idm_a: torch.Tensor
    idm_b: torch.Tensor
    idm_s0: torch.Tensor
    # bottleneck: [start, end) zone with reduced speed limit
    zone_start: torch.Tensor
    zone_end: torch.Tensor
    zone_vmax: torch.Tensor


# EnvParams fields that make physical sense to perturb per agent when building
# a heterogeneous fleet (the asynchronous-MDP knob). Structure stays static.
HETERO_FIELDS = ("dt", "v_max", "idm_v0", "idm_T", "idm_a", "idm_b", "zone_vmax")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static scenario structure + Python-float defaults for the dynamics."""

    name: str
    n_vehicles: int
    rl_indices: tuple          # which vehicles are RL-controlled
    length: float              # ring circumference (m)
    dt: float = 0.1
    v_max: float = 8.0
    a_max: float = 1.5         # RL acceleration scale (m/s^2)
    min_gap: float = 2.0       # collision threshold (m)
    crash_penalty: float = 1.0
    # IDM params for background vehicles
    idm_v0: float = 8.0
    idm_T: float = 1.0
    idm_a: float = 1.3
    idm_b: float = 2.0
    idm_s0: float = 2.0
    # bottleneck: [start, end) zone with reduced speed limit
    zone_start: float = 0.0
    zone_end: float = 0.0
    zone_vmax: float = 8.0

    @property
    def n_rl(self) -> int:
        return len(self.rl_indices)

    def default_params(self, device: Union[str, torch.device] = "cpu"
                       ) -> EnvParams:
        """The defaults as an EnvParams of fp32 0-d tensors on ``device``."""
        return EnvParams(**{
            f: torch.tensor(getattr(self, f), dtype=torch.float32,
                            device=device)
            for f in EnvParams._fields
        })


FIGURE_EIGHT = EnvConfig(
    name="figure_eight",
    n_vehicles=14,
    rl_indices=tuple(range(0, 14, 2)),   # 7 RL vehicles, alternating
    length=230.0,
    zone_start=0.0,
    zone_end=15.0,
    zone_vmax=3.0,                        # intersection analog: slow zone
)

MERGE = EnvConfig(
    name="merge",
    n_vehicles=50,
    rl_indices=tuple(range(0, 50, 10)),  # 5 RL vehicles
    length=700.0,
    v_max=12.0,
    idm_v0=12.0,
    zone_start=0.0,
    zone_end=40.0,
    zone_vmax=4.0,                        # merge-friction zone
)


class EnvState(NamedTuple):
    x: torch.Tensor        # S + (N,) positions
    v: torch.Tensor        # S + (N,) speeds
    crashed: torch.Tensor  # S bool


def stack_params(params_list: Sequence[EnvParams]) -> EnvParams:
    """Stack per-agent EnvParams into one with a leading (m,) axis."""
    return EnvParams(*(torch.stack(ls) for ls in zip(*params_list)))


def broadcast_params(params: EnvParams, shape: tuple) -> EnvParams:
    """Tile an EnvParams along new leading axes (e.g. ``(m,)`` or ``(m, B)``);
    the leaves are contiguous copies."""
    return EnvParams(*(
        l.expand(tuple(shape) + tuple(l.shape)).contiguous() for l in params
    ))


def perturb_params(cfg: EnvConfig, m: int, scale: float,
                   fields: Sequence[str] = HETERO_FIELDS, *,
                   uniforms: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   device: Union[str, torch.device] = "cpu") -> EnvParams:
    """Heterogeneous fleet builder: ``(m,)``-stacked EnvParams, each listed
    field multiplied per agent by ``max(1 + scale * u, 0.1)``.

    ``uniforms`` is the ``(len(fields), m)`` draw of U(-1, 1), one row per
    field in ``fields`` order (the JAX package draws row f from the f-th
    split of its key); without it they are drawn from ``generator``.
    ``scale=0`` returns m identical copies.
    """
    base = cfg.default_params(device)
    fields = tuple(fields)
    unknown = set(fields) - set(EnvParams._fields)
    if unknown:
        raise ValueError(f"perturb_params: unknown fields {sorted(unknown)}")
    static_zero = isinstance(scale, (int, float)) and scale == 0
    if uniforms is None and not static_zero:
        uniforms = 2.0 * torch.rand((len(fields), m), generator=generator,
                                    device=device) - 1.0
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.float32, device=device)
        if tuple(uniforms.shape) != (len(fields), m):
            raise ValueError(f"perturb_params: uniforms must be "
                             f"({len(fields)}, {m}), got "
                             f"{tuple(uniforms.shape)}")
    out = {}
    for f in EnvParams._fields:
        v = getattr(base, f).expand(m)
        if f in fields and not static_zero:
            u = uniforms[fields.index(f)]
            v = v * torch.clamp_min(1.0 + scale * u, 0.1)
        out[f] = v.contiguous()
    return EnvParams(**out)


def _resolve(cfg: EnvConfig, params: Optional[EnvParams], like: torch.Tensor
             ) -> EnvParams:
    return params if params is not None else cfg.default_params(like.device)


@functools.lru_cache(maxsize=None)
def _rl_index(rl_indices: tuple, n: int, device: torch.device):
    """The RL vehicles' indices and their leaders' and followers', uploaded
    once per device (not on every step)."""
    idx = torch.tensor(rl_indices, device=device)
    return idx, (idx + 1) % n, (idx - 1) % n


def _v(leaf: torch.Tensor) -> torch.Tensor:
    """A per-env parameter broadcast over the vehicle axis."""
    return leaf[..., None]


def env_reset(cfg: EnvConfig, jitter_u: torch.Tensor,
              params: Optional[EnvParams] = None) -> EnvState:
    """Reset a batch of envs from its jitter draw.

    ``jitter_u`` is ``S + (N,)`` uniforms on [-0.2, 0.2) (the JAX package's
    ``jax.random.uniform(key, (N,), minval=-0.2, maxval=0.2)``); vehicle i
    starts at ``(i + u_i) * L / N`` modulo L, sorted, at speed 0.5.
    """
    p = _resolve(cfg, params, jitter_u)
    n = cfg.n_vehicles
    if jitter_u.shape[-1] != n:
        raise ValueError(f"env_reset: jitter must end in ({n},), got "
                         f"{tuple(jitter_u.shape)}")
    spacing = _v(p.length / n)
    jitter = jitter_u * spacing
    idx = torch.arange(n, device=jitter_u.device, dtype=torch.float32)
    x = torch.sort(torch.remainder(idx * spacing + jitter, _v(p.length)),
                   dim=-1).values
    v = torch.zeros_like(x) + 0.5
    crashed = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    return EnvState(x=x, v=v, crashed=crashed)


def _gaps(p: EnvParams, x: torch.Tensor) -> torch.Tensor:
    """Leader gap per vehicle: vehicle i's leader is i+1 (mod N) for ever,
    since ``env_reset`` sorts positions and vehicles cannot overtake."""
    return torch.remainder(torch.roll(x, -1, dims=-1) - x, _v(p.length))


def _idm_accel(p: EnvParams, v, gap, v_lead):
    dv = v - v_lead
    s_star = (_v(p.idm_s0) + v * _v(p.idm_T)
              + v * dv / (2.0 * torch.sqrt(_v(p.idm_a * p.idm_b))))
    s_star = torch.clamp_min(s_star, 0.0)
    r = v / _v(p.idm_v0)
    r2 = r * r
    q = s_star / torch.clamp_min(gap, 0.1)
    return _v(p.idm_a) * (1.0 - r2 * r2 - q * q)


def _zone_limit(p: EnvParams, x):
    inz = (x >= _v(p.zone_start)) & (x < _v(p.zone_end))
    return torch.where(inz, _v(p.zone_vmax), _v(p.v_max))


def get_obs(cfg: EnvConfig, state: EnvState,
            params: Optional[EnvParams] = None) -> torch.Tensor:
    """``S + (n_rl, 6)``: [own pos/L, own v/vmax, lead gap/L, lead v/vmax,
    follower gap/L, follower v/vmax] of every RL vehicle."""
    p = _resolve(cfg, params, state.x)
    gaps = _gaps(p, state.x)
    idx, lead, fol = _rl_index(cfg.rl_indices, cfg.n_vehicles, state.x.device)
    L, vmax = _v(p.length), _v(p.v_max)
    return torch.stack(
        [
            state.x[..., idx] / L,
            state.v[..., idx] / vmax,
            gaps[..., idx] / L,
            state.v[..., lead] / vmax,
            gaps[..., fol] / L,
            state.v[..., fol] / vmax,
        ],
        dim=-1,
    )


def env_step(cfg: EnvConfig, state: EnvState, rl_accel: torch.Tensor,
             params: Optional[EnvParams] = None):
    """``rl_accel``: ``S + (n_rl,)`` in [-1, 1]. Returns
    ``(state, reward, crashed_now)`` with ``reward``/``crashed_now`` shaped
    ``S``."""
    p = _resolve(cfg, params, state.x)
    gaps = _gaps(p, state.x)
    v_lead = torch.roll(state.v, -1, dims=-1)
    accel = _idm_accel(p, state.v, gaps, v_lead)
    idx = _rl_index(cfg.rl_indices, cfg.n_vehicles, state.x.device)[0]
    accel = accel.clone()
    accel[..., idx] = torch.clamp(rl_accel, -1.0, 1.0) * _v(p.a_max)
    dt = _v(p.dt)

    # emergency brake if about to collide (slam brakes before a crash)
    ttc_brake = gaps < (_v(p.min_gap) + state.v * dt * 2.0)
    accel = torch.where(ttc_brake, _v(-p.idm_b * 2.0), accel)

    v = torch.minimum(torch.clamp_min(state.v + accel * dt, 0.0),
                      _zone_limit(p, state.x))
    # no-overtaking guard: a vehicle cannot cross its leader in one step
    v = torch.minimum(v, gaps / dt + torch.roll(v, -1, dims=-1))
    x = torch.remainder(state.x + v * dt, _v(p.length))

    new_gaps = _gaps(p, x)
    # a residual crossing (the leader itself clamped) is latched as a crash
    crossed = gaps + (torch.roll(v, -1, dims=-1) - v) * dt < 0.0
    crashed_now = ((new_gaps < _v(p.min_gap) * 0.5).any(-1)
                   | crossed.any(-1))
    crashed = state.crashed | crashed_now
    # NAS reward shared by the team, flipped to the penalty after a crash
    nas = v.mean(-1) / p.v_max
    reward = torch.where(crashed, -p.crash_penalty, nas)
    return EnvState(x=x, v=v, crashed=crashed), reward, crashed_now
