"""Optimizers of the training slice: AdamW, Adafactor and SGD
(``optimizers``), GaLore on the paper's range finder (``galore``) and
sketched gradient compression with error feedback (``compression``)."""
