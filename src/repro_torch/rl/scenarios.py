"""Scenario registry (``repro.rl.scenarios``): named traffic tasks +
heterogeneous-fleet presets.

Each :class:`Scenario` pairs a static :class:`~repro_torch.rl.env.EnvConfig`
with a default heterogeneity recipe — which
:class:`~repro_torch.rl.env.EnvParams` fields a fleet perturbs per agent, and
by how much. ``make_fleet`` turns a scenario name into ``(EnvConfig,
EnvParams)`` where the params carry a leading (m,) axis of per-agent MDPs,
ready for ``repro_torch.rl.rollout`` and the ``num_envs``/``env_params``
knobs on ``FedRLConfig``. The perturbation directions are an operand
(``uniforms``, e.g. the JAX package's draws) or come from a
``torch.Generator``.

Registered scenarios (DESIGN.md §3):

* ``figure_eight``     — the paper's intersection analog (14 vehicles, 7 RL).
* ``merge``            — the paper's merge-friction ring (50 vehicles, 5 RL).
* ``ring_attenuation`` — classic platoon wave-attenuation: one RL vehicle
                         among 21 IDM cars on a plain ring (no slow zone);
                         heterogeneity perturbs the IDM constants and dt, so
                         every agent fights a different stop-and-go wave.
* ``mixed_vmax``       — a 16-vehicle ring where the fleet's heterogeneity
                         is concentrated in the speed limits (v_max, idm_v0
                         ±35% per agent): the mixed-capability fleet stress
                         case for the convergence-bound experiments.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.rl.env import (
    FIGURE_EIGHT,
    HETERO_FIELDS,
    MERGE,
    EnvConfig,
    EnvParams,
    perturb_params,
)

RING_ATTENUATION = EnvConfig(
    name="ring_attenuation",
    n_vehicles=22,
    rl_indices=(0,),
    length=260.0,
    v_max=9.0,
    idm_v0=9.0,
)

MIXED_VMAX = EnvConfig(
    name="mixed_vmax",
    n_vehicles=16,
    rl_indices=tuple(range(0, 16, 4)),   # 4 RL vehicles
    length=250.0,
    v_max=9.0,
    idm_v0=9.0,
)


@dataclasses.dataclass(frozen=True)
class Scenario:
    cfg: EnvConfig
    hetero_scale: float            # default per-agent perturbation scale
    hetero_fields: Tuple[str, ...]  # which EnvParams fields vary per agent
    description: str


SCENARIOS: dict = {
    "figure_eight": Scenario(
        cfg=FIGURE_EIGHT,
        hetero_scale=0.2,
        hetero_fields=HETERO_FIELDS,
        description="intersection analog: slow zone on a 230m loop, 7 RL",
    ),
    "merge": Scenario(
        cfg=MERGE,
        hetero_scale=0.2,
        hetero_fields=HETERO_FIELDS,
        description="merge-friction zone on a 700m ring, 5 RL of 50",
    ),
    "ring_attenuation": Scenario(
        cfg=RING_ATTENUATION,
        hetero_scale=0.25,
        hetero_fields=("dt", "idm_T", "idm_a", "idm_b", "idm_v0"),
        description="platoon wave attenuation: 1 RL of 22, per-agent IDM/dt",
    ),
    "mixed_vmax": Scenario(
        cfg=MIXED_VMAX,
        hetero_scale=0.35,
        hetero_fields=("v_max", "idm_v0"),
        description="mixed-capability fleet: per-agent speed limits +/-35%",
    ),
}


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; registered: {sorted(SCENARIOS)}"
        )
    return SCENARIOS[name]


def make_fleet(
    name: str,
    m: int,
    generator: Optional[torch.Generator] = None,
    hetero: Optional[float] = None,
    fields: Optional[Sequence[str]] = None,
    *,
    uniforms=None,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[EnvConfig, EnvParams]:
    """Build an m-agent heterogeneous fleet for a registered scenario.

    ``hetero`` overrides the scenario's default perturbation scale (0 gives m
    identical MDPs); ``fields`` overrides which params vary. The directions
    are ``uniforms`` (``(len(fields), m)`` draws of U(-1, 1), one row per
    field) or are drawn from ``generator``. Returns the static config plus
    (m,)-stacked per-agent EnvParams on ``device``.
    """
    sc = get_scenario(name)
    scale = sc.hetero_scale if hetero is None else hetero
    flds = tuple(fields) if fields is not None else sc.hetero_fields
    return sc.cfg, perturb_params(sc.cfg, m, scale, flds, uniforms=uniforms,
                                  generator=generator, device=device)
