"""Config module for --arch llava-next-34b (port of
``repro/configs/llava_next_34b.py``;
the canonical definition is in ``archs.py``)."""

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ModelCfg, shapes_for, smoke_config

CONFIG: ModelCfg = ARCHS["llava-next-34b"]
SHAPES = shapes_for(CONFIG)
SMOKE: ModelCfg = smoke_config(CONFIG)
