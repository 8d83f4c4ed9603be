"""Checkpoint / resume for filter and graph state, in the JAX package's
file format.

Counterpart of aruco_slam_tpu/utils/checkpoint.py: a state nest
(NamedTuples, tuples, lists and dicts of tensors or arrays, such as
``(MekfState, frames done, trajectory so far)``) round-trips through
one compressed .npz holding ``num_leaves`` and ``leaf_{i}`` in tree
order. Tree order is JAX's: fields in order, depth first, dict keys
sorted, None an empty subtree. The port's `MekfState` and `GraphState`
have the JAX fields in the JAX order, so a checkpoint written by either
package loads in the other. numpy has no bfloat16: a bf16 leaf is saved
widened to float32 (exact) and cast back on load.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _flatten(tree, leaves: list) -> None:
    if tree is None:
        return
    if isinstance(tree, (tuple, list)):
        for x in tree:
            _flatten(x, leaves)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], leaves)
    else:
        leaves.append(tree)


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(leaves)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path, state) -> None:
    """Persist a state nest (NamedTuples of tensors or arrays)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves: list = []
    _flatten(state, leaves)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    np.savez_compressed(path, num_leaves=np.int64(len(leaves)), **arrays)


def _cast(x: np.ndarray, like):
    """A loaded leaf as the template leaf's kind: a tensor of its dtype
    on its device, an array of its dtype, else the array as loaded."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(x).to(dtype=like.dtype, device=like.device)
    if hasattr(like, "dtype"):
        return np.asarray(x, like.dtype)
    return x


def load_checkpoint(path, like):
    """Restore into the structure of ``like``, a template nest of the
    same structure (e.g. what init_state / init_graph return), each
    leaf onto the template leaf's device and dtype. A checkpoint with
    fewer leaves than the template (written before a state field was
    appended, e.g. MekfState.dropped_obs) takes the missing trailing
    leaves from the template; one with more raises ValueError."""
    with np.load(Path(path)) as data:
        n = int(data["num_leaves"])
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    template: list = []
    _flatten(like, template)
    if len(template) < n:
        raise ValueError(f"checkpoint has {n} leaves, template has "
                         f"{len(template)}")
    cast = [_cast(x, t) for x, t in zip(leaves, template)] + template[n:]
    return _unflatten(like, iter(cast))
