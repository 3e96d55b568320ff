"""Logical-axis -> mesh-axis rules and the spec of every leaf (port of
``repro/sharding/rules.py``).

Parallelism layout (the reference's DESIGN.md §6):
  * batch            -> ("pod", "data")   [DP; pod is the outer DP axis]
  * heads/mlp/inner/
    expert/vocab     -> "model"           [TP / EP megatron-style]
  * embed (weights)  -> "data"            [FSDP / zero-3 within pod]
  * decode KV seq    -> "model"           [flash-decoding style sharded cache]
  * long-context (B=1) cache seq / window -> ("data", "model") as divisible

A spec is the reference's ``PartitionSpec`` as a tuple: one entry a dim, a
mesh axis name, a tuple of names or None (``()`` for the reference's
``P()``, replicated).  ``mesh`` is a ``launch.mesh.HostMesh``; the specs
need only its ``shape``, so an unbound mesh serves.  Every rule is
divisibility-checked against the actual dim: a non-divisible axis is
dropped (replicated).

``shard_params`` cuts whole tensors into this rank's slices and
``gather_params`` puts them back together (a bound mesh, collectively).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelCfg, ShapeCfg
from repro_torch.models import transformer as T
from repro_torch.sharding import activation as A

# logical axis -> preferred mesh axis (params)
PARAM_RULES: dict[str, Optional[str]] = {
    "vocab": "model",
    "embed": "data",      # FSDP shard of the non-TP weight dim
    "heads": "model",
    "mlp": "model",
    "inner": "model",
    "expert": "model",
    "layers": None,       # scan dim: never sharded
    "inner2": None,
    "embed2": None,
}


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= mesh.shape[a]
        return n
    return mesh.shape[name]


def _maybe(mesh, dim: int, axis):
    """axis if dim is divisible by its mesh size, else None (replicate)."""
    if axis is None:
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def tp_enabled(cfg: ModelCfg) -> bool:
    """The reference's auto-layout: tensor parallelism pays only from ~3k
    d_model.  Expert parallelism does not depend on it."""
    return cfg.d_model >= 3072


def param_specs(cfg: ModelCfg, mesh, serving: bool = False) -> dict[str, tuple]:
    """The spec of every parameter, from the schema's logical axes.

    serving=True + non-TP arch: weights live replicated (the serving
    layout), all but the vocab-sharded tables and the expert weights."""
    replicate_all = serving and not tp_enabled(cfg)
    out = {}
    for name, d in T.schema(cfg).items():
        if replicate_all and "vocab" not in d.axes and "expert" not in d.axes:
            out[name] = (None,) * len(d.shape)
            continue
        out[name] = tuple(_maybe(mesh, dim, PARAM_RULES.get(ax))
                          for dim, ax in zip(d.shape, d.axes))
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def opt_state_specs(cfg: ModelCfg, mesh, opt_state) -> dict:
    """Param specs mirrored onto the optimizer's moments; Adafactor's
    factored statistics and the scalars replicated (``()``)."""
    pspecs = param_specs(cfg, mesh)

    def for_tree(tree):
        if isinstance(tree, dict) and set(tree) >= set(pspecs):
            return {k: (pspecs[k] if k in pspecs else ()) for k in tree}
        return _tree_map(lambda _: (), tree)

    out = {}
    for key, sub in opt_state.items():
        if key in ("m", "v"):
            out[key] = for_tree(sub)
        elif key == "s":  # adafactor: factored moments lose the last dim
            out[key] = _tree_map(lambda _: (), sub)
        else:
            out[key] = ()
    return out


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def batch_specs(cfg: ModelCfg, shape: Optional[ShapeCfg], mesh, inputs) -> dict:
    """The specs of the input tree of one shape cell (leaves need only a
    ``shape``)."""
    ba = batch_axes(mesh)

    def spec_for(path, leaf) -> tuple:
        name = "/".join(str(p) for p in path)
        dims = tuple(leaf.shape)
        if name == "write_pos" or not dims:
            return ()
        if "cache" in name:
            # scan-stacked cache leaves carry a leading n_periods dim
            lead = "cache/scan" in name
            body = dims[1:] if lead else dims
            b = _maybe(mesh, body[0], ba)
            if b is None and isinstance(ba, tuple):
                b = _maybe(mesh, body[0], "data")
            spec = _cache_leaf_spec(name, body, mesh, b)
            return (None,) + spec if lead else spec
        b = _maybe(mesh, dims[0], ba)
        if b is None and isinstance(ba, tuple):
            b = _maybe(mesh, dims[0], "data")
        if name.startswith(("tokens", "labels")):
            return (b,)
        if name.startswith(("img_embeds", "enc_embeds")):
            return (b, None, None)
        return (b,)

    return _map_with_path(spec_for, inputs)


def _cache_leaf_spec(name: str, dims, mesh, b) -> tuple:
    """Cache leaves (k/v/xk/xv (B,S,KV,hd), ckv/kr (B,S,r), conv (B,W-1,C),
    h/c/n recurrent states)."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf in ("k", "v", "xk", "xv"):
        # sequence-sharded KV (flash-decoding); fall back over both spare axes
        s_ax = _maybe(mesh, dims[1], "model")
        if b is None and s_ax is not None:
            s_ax = _maybe(mesh, dims[1], ("data", "model") if
                          "pod" not in mesh.axis_names else
                          ("pod", "data", "model")) or s_ax
        return (b, s_ax) + (None,) * (len(dims) - 2)
    if leaf in ("ckv", "kr"):
        return (b, _maybe(mesh, dims[1], "model"), None)
    if leaf == "conv":
        return (b, None, _maybe(mesh, dims[-1], "model"))
    # recurrent states: shard the widest trailing dim over model
    if len(dims) >= 2:
        spec = [b] + [None] * (len(dims) - 1)
        spec[-1] = _maybe(mesh, dims[-1], "model")
        return tuple(spec)
    return (b,)


def shard_params(cfg: ModelCfg, mesh, params: dict,
                 specs: Optional[dict] = None) -> dict:
    """This rank's slice of each whole param (``specs`` defaults to the
    training layout, as the reference's)."""
    specs = param_specs(cfg, mesh) if specs is None else specs
    return {k: A.shard_leaf(v, specs[k], mesh) for k, v in params.items()}


def gather_params(cfg: ModelCfg, mesh, params: dict,
                  specs: Optional[dict] = None) -> dict:
    """The whole params from every rank's slices (collective over the
    mesh; not differentiable)."""
    specs = param_specs(cfg, mesh) if specs is None else specs
    return {k: A.gather_leaf(v, specs[k], mesh)
            for k, v in sorted(params.items())}
