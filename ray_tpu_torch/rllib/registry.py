"""Algorithm registry (reference analog: rllib/algorithms/registry.py
get_algorithm_class) — string name → (Algorithm, Config) for CLI/Tune
style launch-by-name.

A copy of ``ray_tpu/rllib/registry.py``: the same names.  PPO, PG, A2C
and A3C resolve; every other registered algorithm raises
NotImplementedError naming the ROADMAP item its module waits for
(``UNPORTED``), an unknown name ValueError as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict, Tuple

#: registry name → (Algorithm attr, Config attr) on ray_tpu.rllib.
#: Single source of truth: registered_algorithms() derives from it.
_TABLE = {
    "PPO": ("PPO", "PPOConfig"),
    "APPO": ("APPO", "APPOConfig"),
    "DDPPO": ("DDPPO", "DDPPOConfig"),
    "IMPALA": ("IMPALA", "IMPALAConfig"),
    "PG": ("PG", "PGConfig"),
    "A2C": ("A2C", "A2CConfig"),
    "A3C": ("A3C", "A3CConfig"),
    "DQN": ("DQN", "DQNConfig"),
    "SimpleQ": ("SimpleQ", "SimpleQConfig"),
    "ApexDQN": ("ApexDQN", "ApexDQNConfig"),
    "APEX": ("ApexDQN", "ApexDQNConfig"),
    "ApexDDPG": ("ApexDDPG", "ApexDDPGConfig"),
    "Rainbow": ("Rainbow", "RainbowConfig"),
    "R2D2": ("R2D2", "R2D2Config"),
    "SAC": ("SAC", "SACConfig"),
    "TD3": ("TD3", "TD3Config"),
    "DDPG": ("DDPG", "DDPGConfig"),
    "ES": ("ES", "ESConfig"),
    "ARS": ("ARS", "ARSConfig"),
    "BC": ("BC", "BCConfig"),
    "MARWIL": ("MARWIL", "MARWILConfig"),
    "CQL": ("CQL", "CQLConfig"),
    "CRR": ("CRR", "CRRConfig"),
    "DT": ("DT", "DTConfig"),
    "SlateQ": ("SlateQ", "SlateQConfig"),
    "AlphaZero": ("AlphaZero", "AlphaZeroConfig"),
    "MAML": ("MAML", "MAMLConfig"),
    "MBMPO": ("MBMPO", "MBMPOConfig"),
    "Dreamer": ("Dreamer", "DreamerConfig"),
    "AlphaStar": ("LeagueTrainer", "LeagueConfig"),
    "League": ("LeagueTrainer", "LeagueConfig"),
    "QMIX": ("QMIX", "QMIXConfig"),
    "MADDPG": ("MADDPG", "MADDPGConfig"),
    "MultiAgentPPO": ("MultiAgentPPO", "MultiAgentPPOConfig"),
    "BanditLinUCB": ("LinUCB", "LinUCBConfig"),
    "BanditLinTS": ("LinTS", "LinTSConfig"),
}

#: what the rest of the JAX package's rllib waits for
RLLIB_ITEM = "ROADMAP.md queue 1 items 7.13 (b)-(d) (rllib/)"

#: ROADMAP queue 1 item 7.13's parts not ported yet → (module → the
#: names of ray_tpu.rllib's namespace it defines)
UNPORTED: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "b": {
        "impala": ("IMPALA", "IMPALAConfig", "APPO", "APPOConfig",
                   "vtrace"),
        "ddppo": ("DDPPO", "DDPPOConfig"),
        "dqn": ("DQN", "DQNConfig", "QPolicy"),
        "dqn_variants": ("SimpleQ", "SimpleQConfig", "ApexDQN",
                         "ApexDQNConfig", "Rainbow", "RainbowConfig"),
        "r2d2": ("R2D2", "R2D2Config", "R2D2Policy"),
        "offline": ("BC", "BCConfig", "MARWIL", "MARWILConfig",
                    "JsonReader", "JsonWriter"),
    },
    "c": {
        "sac": ("SAC", "SACConfig", "SACPolicy"),
        "td3": ("TD3", "TD3Config", "TD3Policy", "DDPG", "DDPGConfig",
                "ApexDDPG", "ApexDDPGConfig"),
        "cql_es": ("CQL", "CQLConfig", "ES", "ESConfig"),
        "crr": ("CRR", "CRRConfig"),
        "multi_agent": ("MultiAgentEnv", "MultiAgentPPO",
                        "MultiAgentPPOConfig"),
        "maddpg": ("MADDPG", "MADDPGConfig", "MADDPGPolicy"),
        "qmix": ("QMIX", "QMIXConfig", "QMIXPolicy"),
        "league": ("LeagueTrainer", "LeagueConfig", "pfsp_weights"),
    },
    "d": {
        "ars": ("ARS", "ARSConfig"),
        "bandit": ("LinUCB", "LinUCBConfig", "LinTS", "LinTSConfig"),
        "slateq": ("SlateQ", "SlateQConfig", "SlateQPolicy"),
        "alpha_zero": ("AlphaZero", "AlphaZeroConfig", "AZNet", "MCTS"),
        "dreamer": ("Dreamer", "DreamerConfig"),
        "dt": ("DT", "DTConfig"),
        "maml": ("MAML", "MAMLConfig"),
        "mbmpo": ("MBMPO", "MBMPOConfig"),
    },
}


def unported_item(attr: str):
    """The ROADMAP item an unported name of the rllib namespace waits
    for (None for a ported or unknown name)."""
    for part, modules in UNPORTED.items():
        for module, names in modules.items():
            if attr in names:
                return (f"ROADMAP.md queue 1 item 7.13 ({part}) "
                        f"(rllib/{module}.py)")
    return None


def get_algorithm_class(name: str, return_config: bool = False):
    """Resolve an algorithm by its registry name.  Imports lazily so
    `from ray_tpu_torch.rllib.registry import get_algorithm_class`
    stays cheap."""
    if name not in _TABLE:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: "
            f"{sorted(_TABLE)}")
    cls_name, cfg_name = _TABLE[name]
    item = unported_item(cls_name)
    if item is not None:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet: {item}")
    import ray_tpu_torch.rllib as rllib

    cls = getattr(rllib, cls_name)
    if return_config:
        return cls, getattr(rllib, cfg_name)
    return cls


def registered_algorithms() -> Tuple[str, ...]:
    """All registry names (for docs/CLI tab-completion)."""
    return tuple(_TABLE)
