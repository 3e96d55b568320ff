"""Config module for --arch qwen3-0.6b (port of
``repro/configs/qwen3_0_6b.py``;
the canonical definition is in ``archs.py``)."""

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ModelCfg, shapes_for, smoke_config

CONFIG: ModelCfg = ARCHS["qwen3-0.6b"]
SHAPES = shapes_for(CONFIG)
SMOKE: ModelCfg = smoke_config(CONFIG)
