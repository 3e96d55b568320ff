"""Config module for --arch deepseek-v2-lite-16b (port of
``repro/configs/deepseek_v2_lite_16b.py``;
the canonical definition is in ``archs.py``)."""

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ModelCfg, shapes_for, smoke_config

CONFIG: ModelCfg = ARCHS["deepseek-v2-lite-16b"]
SHAPES = shapes_for(CONFIG)
SMOKE: ModelCfg = smoke_config(CONFIG)
