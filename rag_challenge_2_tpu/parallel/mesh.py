"""Device-mesh construction and sharding rules.

The reference has no model/data parallelism at all (SURVEY.md §2.3 — its
"distributed" layer is thread pools around HTTP).  Here the mesh is a
first-class object: index rows shard over ``data``, encoder weights shard
over ``model`` (tensor parallelism), and XLA inserts the collectives
(all-gather / psum / reduce-scatter) over the device interconnect.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axes: Dict[str, int],
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Mesh over the first prod(axes) devices, axis order as given.

    ``make_mesh({"data": 4, "model": 2})`` on 8 devices → 4×2 mesh.
    """
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    n = int(np.prod(shape))
    devs = list(devices if devices is not None else jax.devices())
    if len(devs) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
    arr = np.asarray(devs[:n]).reshape(shape)
    return Mesh(arr, names)


def cpu_mesh(axes: Dict[str, int]) -> Mesh:
    """Mesh over virtual CPU devices (tests / dry runs without accelerators)."""
    return make_mesh(axes, devices=jax.devices("cpu"))


# ---- encoder parameter sharding rules (tensor parallelism) --------------

def encoder_param_spec(path: tuple, leaf) -> P:
    """PartitionSpec for an encoder parameter by its tree path.

    TP layout: token/pos embeddings and attention QKV shard their output
    (feature) dim; MLP shards d_ff; output projections shard their input
    dim, producing a psum at the block boundary (the standard Megatron
    split, expressed to GSPMD instead of NCCL).
    """
    names = [getattr(k, "key", str(k)) for k in path]
    joined = "/".join(names)
    nd = leaf.ndim
    if nd == 0:
        return P()
    if "tok_embed" in joined or "pos_embed" in joined:
        return P(None, "model") if nd == 2 else P()
    if "attn" in joined:
        if "out" in joined:
            # out proj kernel [heads, head_dim, d_model]; bias [d_model] replicated
            return P("model", None, None) if nd == 3 else P()
        # q/k/v kernels [d_model, heads, head_dim]; biases [heads, head_dim]
        return P(None, "model", None) if nd == 3 else (
            P("model", None) if nd == 2 else P()
        )
    if "moe" in joined:
        if "router" in joined:
            return P()
        # expert weights [E, ., .]: experts shard over 'model' (ep)
        return P("model", None, None) if nd == 3 else P()
    if "mlp_in" in joined:
        return P(None, "model") if nd == 2 else P("model")
    if "mlp_out" in joined:
        # kernel [d_ff, d_model] shards input dim → psum at block boundary
        return P("model", None) if nd == 2 else P()
    return P()  # final proj, norms, remaining biases → replicated


def shard_params(params, mesh: Mesh):
    """Place an encoder param tree onto the mesh per `encoder_param_spec`.

    Spec axes the mesh doesn't carry degrade to replication (a dp×pp mesh
    has no ``model`` axis; the TP split simply doesn't apply there)."""
    def place(path, leaf):
        spec = encoder_param_spec(path, leaf)
        spec = P(*(a if a in mesh.shape else None for a in spec))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(place, params)
