"""Carry state across from the JAX package's numpy form into the port.

The JAX package's ``SimParams``, ``SimState`` and ``VCCProblem``, turned
into nested dicts of numpy arrays (``jax.tree.map(np.asarray, x)`` and the
fields as a dict), become the port's tuples on ``device``:

* uint32 key words -> int64 (the port's key representation);
* other integers -> int64, booleans stay bool, floats -> float32.

The parity tests use these to feed both sides identical inputs stage by
stage. The intraday hour channels and the streaming carry (``pred``, a
``PredictorState`` with its nested ``DevMoments`` / ``EWMoments``) come
across when present; None stays None.

``model_params_from_numpy`` carries a JAX model's parameter pytree (as
numpy, layers stacked on leading axes for ``lax.scan``) into the port's
module state, so both packages compute with the same weights.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import stages, stats, vcc


def tensor(x, device=None) -> torch.Tensor:
    """One numpy array (or scalar) -> tensor with the port's dtypes."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int64), device=device)
    return torch.tensor(a.astype(np.float32), device=device)


def _tree(x, device):
    if x is None:
        return None
    if isinstance(x, Mapping):
        return {k: _tree(v, device) for k, v in x.items()}
    return tensor(x, device)


def _fields(tree, cls):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    elif not isinstance(tree, Mapping):
        tree = {k: getattr(tree, k) for k in vars(tree)}
    # a field with a default (None) may be absent; every other must be there
    return {k: tree.get(k) if k in cls._field_defaults else tree[k]
            for k in cls._fields}


def params_from_numpy(tree, device=None) -> stages.SimParams:
    """The JAX ``SimParams`` (nested dict of numpy arrays) -> the port's."""
    return stages.SimParams(**{k: _tree(v, device) for k, v in
                               _fields(tree, stages.SimParams).items()})


# the PredictorState fields that nest moments, and their port types
_MOMENTS = {"uif_dev": stats.DevMoments, "flex_dev": stats.DevMoments,
            "res_dev": stats.DevMoments, "ratio": stats.EWMoments}


def predictor_from_numpy(tree, device=None) -> stats.PredictorState:
    """The JAX ``stats.PredictorState`` (a NamedTuple or dict of numpy
    arrays, its moments nested the same way) -> the port's."""
    leaves = _fields(tree, stats.PredictorState)
    return stats.PredictorState(**{
        k: _MOMENTS[k](**{f: tensor(x, device) for f, x in
                          _fields(v, _MOMENTS[k]).items()})
        if k in _MOMENTS else tensor(v, device) for k, v in leaves.items()})


def state_from_numpy(tree, device=None) -> stages.SimState:
    """The JAX ``SimState`` (dict of numpy arrays; streaming or rescan) ->
    the port's."""
    leaves = _fields(tree, stages.SimState)
    pred = leaves.pop("pred")
    return stages.SimState(
        **{k: _tree(v, device) for k, v in leaves.items()},
        pred=None if pred is None else predictor_from_numpy(pred, device))


def problem_from_numpy(tree, device=None) -> vcc.VCCProblem:
    """The JAX ``VCCProblem`` (its fields as numpy arrays) -> the port's.
    A problem with forecast members keeps ``eta_ens``, ``pow_nom_ens`` and
    ``risk_beta``; without them all three are None (the reference's
    ``risk_beta`` default of 1.0 acts only on members)."""
    if not isinstance(tree, Mapping):
        tree = {k: getattr(tree, k) for k in vars(tree)}
    ens = tree.get("eta_ens") is not None
    fields = {f: tensor(tree[f], device) if ens or f not in ENSEMBLE
              else None
              for f in vcc.VCCProblem.__dataclass_fields__
              if f != "drop_limit"}
    return vcc.VCCProblem(**fields,
                          drop_limit=float(tree.get("drop_limit", 0.8)))


ENSEMBLE = ("eta_ens", "pow_nom_ens", "risk_beta")


# pytree keys whose leaves stack layers on leading axes, and how many
STACKED = {"stack": 1, "groups": 2, "trail": 1, "enc_stack": 1,
           "dec_stack": 1}


def _torch_dtype(a):
    name = np.asarray(a).dtype.name
    return {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        name, torch.float32)


def model_params_from_numpy(cfg, tree, device=None) -> dict:
    """The JAX model's parameters (a nested dict of numpy arrays; bfloat16
    leaves as ``ml_dtypes`` arrays) -> the port's ``state_dict`` for
    ``build_model(cfg)``: layer ``i`` of a stacked subtree (``stack``,
    ``trail``, an encoder-decoder's ``enc_stack`` and ``dec_stack``;
    ``groups`` with two axes, group and layer) becomes module
    ``<key>.i`` (``groups.g.i``), an unstacked subtree (an MoE model's
    ``prefix_{i}``) module ``<key>``, and each leaf keeps its type. Raises
    if a stacked subtree does not hold ``cfg``'s layers (an MoE model's
    ``stack`` holds those after its ``first_dense_layers``)."""
    m = cfg.attn_every or 1
    n_prefix = cfg.moe.first_dense_layers if cfg.moe else 0
    layers = {"stack": (cfg.num_layers - n_prefix,),
              "groups": (cfg.num_layers // m, m),
              "trail": (cfg.num_layers % m,),
              "enc_stack": (cfg.encoder_layers,),
              "dec_stack": (cfg.num_layers,)}
    state = {}

    def leaves(x, path):
        if isinstance(x, Mapping):
            for k, v in x.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, x

    for path, x in leaves(tree, ()):
        dt = _torch_dtype(x)
        a = np.asarray(x).astype(np.float32)
        n_axes = STACKED.get(path[0], 0)
        if n_axes and a.shape[:n_axes] != layers[path[0]]:
            raise ValueError(f"{'.'.join(path)}: layers {a.shape[:n_axes]}, "
                             f"{cfg.name} has {layers[path[0]]}")
        for idx in np.ndindex(*a.shape[:n_axes]):
            name = ".".join((path[0],) + tuple(map(str, idx)) + path[1:])
            state[name] = torch.tensor(a[idx], device=device).to(dt)
    return state
