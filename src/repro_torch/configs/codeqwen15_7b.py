"""Config module for --arch codeqwen1.5-7b (port of
``repro/configs/codeqwen15_7b.py``;
the canonical definition is in ``archs.py``)."""

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ModelCfg, shapes_for, smoke_config

CONFIG: ModelCfg = ARCHS["codeqwen1.5-7b"]
SHAPES = shapes_for(CONFIG)
SMOKE: ModelCfg = smoke_config(CONFIG)
