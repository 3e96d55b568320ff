"""Config module for --arch command-r-plus-104b (port of
``repro/configs/command_r_plus_104b.py``;
the canonical definition is in ``archs.py``)."""

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ModelCfg, shapes_for, smoke_config

CONFIG: ModelCfg = ARCHS["command-r-plus-104b"]
SHAPES = shapes_for(CONFIG)
SMOKE: ModelCfg = smoke_config(CONFIG)
