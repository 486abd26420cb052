"""Multi-device scaling over a device mesh.

The reference is single-process single-GPU (SURVEY.md section 2: no comm
library at all); its scaling axis is "bit coalescing" into one device's batch.
The generalization is *bit coalescing across devices*: independent
ciphertext bits/gates are data-parallel, so we shard the gate batch over a
`jax.sharding.Mesh` with `shard_map` (keys replicated; no ciphertext crosses
a device link unless a collective op like Cannon's matmul needs it).

Axes:
  dp  - gate/ciphertext batch (the bit-coalescing axis)
  ks  - optional key-switch table sharding (rows of the KS matmul), reduced
        with psum; demonstrates intra-kernel tensor parallelism.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core.lwe import LweCiphertext
from ..core import bootstrap as bs
from .. import gates


def make_mesh(n_devices: int | None = None, axis_name: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def _replicated_cloud_spec(cloud):
    return jax.tree.map(lambda _: P(), cloud)


def _batch_ct_spec(axis="dp"):
    return LweCiphertext(a=P(axis, None), b=P(axis), cv=P(axis))


def sharded_gate2(name: str, x: LweCiphertext, y: LweCiphertext, cloud,
                  mesh: Mesh, axis: str = "dp") -> LweCiphertext:
    """A 2-input bootstrapped gate with the batch sharded across the mesh.

    Requires batch size divisible by mesh size. Keys are replicated; each chip
    bootstraps its local shard (zero cross-device traffic - the DP analog of bit
    coalescing, SURVEY.md section 2 item 3).
    """
    const, ca, cb = gates.GATE_TABLE[name]

    def local(xs, ys, ck):
        t = gates._affine2(xs, ys, jnp.int32(const), jnp.int32(ca), jnp.int32(cb))
        return bs.bootstrap(t, jnp.int32(gates.MU), ck)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(_batch_ct_spec(axis), _batch_ct_spec(axis), _replicated_cloud_spec(cloud)),
        out_specs=_batch_ct_spec(axis),
        check_vma=False,
    )
    return jax.jit(fn)(x, y, cloud)


def sharded_bootstrap_step(x: LweCiphertext, cloud, mesh: Mesh, axis: str = "dp"):
    """Full batched bootstrap sharded over the mesh (used by dryrun/benchmarks)."""
    def local(xs, ck):
        return bs.bootstrap(xs, jnp.int32(gates.MU), ck)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(_batch_ct_spec(axis), _replicated_cloud_spec(cloud)),
        out_specs=_batch_ct_spec(axis),
        check_vma=False,
    )
    return jax.jit(fn)(x, cloud)


def sharded_circuit(circuit, cts, cloud, mesh: Mesh, axis: str = "dp"):
    """Run a whole multi-gate CIRCUIT data-parallel over the mesh: the leading
    batch axis of every input ciphertext is sharded, keys replicated, and the
    entire circuit traces into ONE sharded program per chip (every gate,
    compressor level and carry chain included — no per-gate re-sharding).

    circuit: (ct, ..., cloud) -> ct, any tfhe_tpu circuit whose leading batch
    axis indexes independent work items (all of arith/linalg qualifies: the
    reference's `_vector` variants are the same circuits on a bigger batch).
    cts: tuple of input ciphertexts, leading axis divisible by the mesh.

    DP over the bit-coalescing axis with zero cross-device traffic inside
    the circuit.
    """
    def spec(ct):
        nb = len(ct.batch_shape)
        return LweCiphertext(a=P(axis, *([None] * nb)),
                             b=P(axis, *([None] * (nb - 1))),
                             cv=P(axis, *([None] * (nb - 1))))

    fn = shard_map(
        lambda *args: circuit(*args),
        mesh=mesh,
        in_specs=tuple(spec(c) for c in cts) + (_replicated_cloud_spec(cloud),),
        out_specs=spec(cts[0]),
        check_vma=False,
    )
    return jax.jit(fn)(*cts, cloud)


def make_mesh2d_dp_ks(dp: int, ks: int) -> Mesh:
    import numpy as np
    devs = np.array(jax.devices()[: dp * ks]).reshape(dp, ks)
    return Mesh(devs, ("dp", "ks"))


def sharded_gate2_tp_ks(name: str, x: LweCiphertext, y: LweCiphertext, cloud,
                        mesh: Mesh) -> LweCiphertext:
    """2-D sharded gate: batch over BOTH mesh axes for the blind rotate, then
    key-switch with the KS table tensor-parallel over the `ks` axis.

    This is the multi-chip form of the reference's two hot loops: blind rotate
    is embarrassingly batch-parallel (bit coalescing across all chips), while
    the key-switch table (the 84M-entry gather table of
    `lwe-keyswitch-functions.cu`, here the int8 limb matmul operand) is too
    large to replicate at scale — so its ROWS are sharded over `ks` chips,
    each chip contracts its row block against its batch gathered over the
    `ks` axis, and one `psum` across devices reduces the partial key-switch sums.

    Requires batch % (dp*ks) == 0 and n_extract % ks == 0.
    """
    const, ca, cb = gates.GATE_TABLE[name]
    dp_size, ks_size = mesh.devices.shape
    params = cloud.params
    batch = int(np.prod(x.batch_shape)) if x.batch_shape else 1
    assert batch % (dp_size * ks_size) == 0, (
        f"batch {batch} must divide over the {dp_size}x{ks_size} mesh")
    assert params.n_extract % ks_size == 0, (
        f"n_extract {params.n_extract} not divisible by ks={ks_size}")
    assert cloud.ks_table.shape[0] % ks_size == 0, (
        f"KS table rows {cloud.ks_table.shape[0]} not divisible by ks={ks_size}")
    cols_per = params.n_extract // ks_size

    # ciphertext batch sharded over the flattened (dp, ks) axes
    ct_spec = LweCiphertext(a=P(("dp", "ks"), None), b=P(("dp", "ks")), cv=P(("dp", "ks")))
    # cloud key: BK replicated, KS table row-sharded over ks
    cloud_spec = jax.tree.map(lambda _: P(), cloud)
    cloud_spec = type(cloud_spec)(
        params=cloud_spec.params, bk_ntt=P(), bk_ntt_shoup=P(),
        ks_table=P("ks", None))

    def local(xs, ys, ck):
        t = gates._affine2(xs, ys, jnp.int32(const), jnp.int32(ca), jnp.int32(cb))
        a_ext, b_ext, cv = bs.bootstrap_woks(t, jnp.int32(gates.MU), ck)
        # gather the batch across the ks axis; each chip key-switches the
        # whole ks-group batch against its KS-table row shard
        a_all = jax.lax.all_gather(a_ext, "ks", axis=0, tiled=True)
        b_all = jax.lax.all_gather(b_ext, "ks", axis=0, tiled=True)
        cv_all = jax.lax.all_gather(cv, "ks", axis=0, tiled=True)
        i = jax.lax.axis_index("ks")
        a_slice = jax.lax.dynamic_slice_in_dim(a_all, i * cols_per, cols_per, axis=1)
        onehot = bs.ks_onehot(a_slice, params)                   # [B_ks, rows_per]
        sums = jnp.matmul(onehot, ck.ks_table, preferred_element_type=jnp.int32)
        sums = jax.lax.psum(sums, "ks")
        out = bs.ks_finalize(sums, b_all, cv_all, params)
        # re-split the batch: keep this chip's ks-slice
        bsz = xs.b.shape[0]
        return LweCiphertext(
            jax.lax.dynamic_slice_in_dim(out.a, i * bsz, bsz, axis=0),
            jax.lax.dynamic_slice_in_dim(out.b, i * bsz, bsz, axis=0),
            jax.lax.dynamic_slice_in_dim(out.cv, i * bsz, bsz, axis=0))

    fn = shard_map(local, mesh=mesh,
                   in_specs=(ct_spec, ct_spec, cloud_spec),
                   out_specs=ct_spec, check_vma=False)
    return jax.jit(fn)(x, y, cloud)
