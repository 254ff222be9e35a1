"""Carry state across from the JAX package's numpy form into the port.

The JAX package's ``SimParams``, ``SimState`` and ``VCCProblem``, turned
into nested dicts of numpy arrays (``jax.tree.map(np.asarray, x)`` and the
fields as a dict), become the port's tuples on ``device``:

* uint32 key words -> int64 (the port's key representation);
* other integers -> int64, booleans stay bool, floats -> float32.

The parity tests use these to feed both sides identical inputs stage by
stage. Fields of later slices (the intraday channels, the streaming carry)
must be absent or None.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import stages, vcc


def tensor(x, device=None) -> torch.Tensor:
    """One numpy array (or scalar) -> tensor with the port's dtypes."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int64), device=device)
    return torch.tensor(a.astype(np.float32), device=device)


def _tree(x, device):
    if isinstance(x, Mapping):
        return {k: _tree(v, device) for k, v in x.items()}
    return tensor(x, device)


def _fields(tree, cls, later=()):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    elif not isinstance(tree, Mapping):
        tree = {k: getattr(tree, k) for k in vars(tree)}
    for name in later:
        if tree.get(name) is not None:
            raise NotImplementedError(f"{cls.__name__}.{name} is not ported "
                                      "yet")
    return {k: tree[k] for k in cls._fields}


def params_from_numpy(tree, device=None) -> stages.SimParams:
    """The JAX ``SimParams`` (nested dict of numpy arrays) -> the port's."""
    leaves = _fields(tree, stages.SimParams,
                     later=("arrival_hour_scale", "carbon_hour_scale"))
    return stages.SimParams(**{k: _tree(v, device)
                               for k, v in leaves.items()})


def state_from_numpy(tree, device=None) -> stages.SimState:
    """The JAX rescan ``SimState`` (dict of numpy arrays) -> the port's."""
    leaves = _fields(tree, stages.SimState, later=("pred",))
    return stages.SimState(**{k: _tree(v, device)
                              for k, v in leaves.items()})


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
