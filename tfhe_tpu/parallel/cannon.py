"""Cannon's algorithm over a 2-D device mesh with neighbor permutes.

The reference implements Cannon's algorithm on a single GPU, simulating the
block grid with leftRotate/upRotate kernels (`gpuParallel/main.cu:2590-2644,
2531-2557`; paper section V-B3) to fit the fixed memory. On a mesh the
algorithm is in its natural habitat: one matrix block per device, with the
shift-multiply-accumulate rotations as `jax.lax.ppermute` collectives between
devices — zero host involvement.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import arith
from ..core.lwe import LweCiphertext


def make_mesh2d(d: int, axis_names=("mr", "mc")) -> Mesh:
    devs = np.array(jax.devices()[: d * d]).reshape(d, d)
    return Mesh(devs, axis_names)


def cannon_matmul_mesh(a: LweCiphertext, b: LweCiphertext, cloud, mesh: Mesh):
    """Element-grid Cannon matmul: a, b: [D, D, nbits] encrypted matrices,
    one element per device on a DxD mesh. Returns [D, D, nbits]."""
    d = mesh.devices.shape[0]
    assert mesh.devices.shape == (d, d)
    mr, mc = mesh.axis_names

    ct_spec = LweCiphertext(a=P(mr, mc, None, None), b=P(mr, mc, None), cv=P(mr, mc, None))
    cloud_spec = jax.tree.map(lambda _: P(), cloud)

    def shift_perm(axis_size, by):
        return [(i, (i - by) % axis_size) for i in range(axis_size)]

    def pshift(ct: LweCiphertext, axis: str, by: int) -> LweCiphertext:
        perm = shift_perm(d, by)
        return jax.tree.map(lambda x: jax.lax.ppermute(x, axis, perm), ct)

    def local(ablk: LweCiphertext, bblk: LweCiphertext, ck):
        # initial skew: row i of A left by i; col j of B up by j.
        i = jax.lax.axis_index(mr)
        j = jax.lax.axis_index(mc)
        # per-device-dependent skew: perform in log2(d) conditional hops
        a_sk, b_sk = ablk, bblk
        step = 1
        while step < d:
            bit_a = (i // step) % 2 == 1
            bit_b = (j // step) % 2 == 1
            a_hop = pshift(a_sk, mc, step)
            b_hop = pshift(b_sk, mr, step)
            a_sk = jax.tree.map(lambda h, o: jnp.where(bit_a, h, o), a_hop, a_sk)
            b_sk = jax.tree.map(lambda h, o: jnp.where(bit_b, h, o), b_hop, b_sk)
            step *= 2
        acc = None
        for _ in range(d):
            prod = arith.mul(a_sk, b_sk, ck)
            acc = prod if acc is None else arith.add(acc, prod, ck)
            a_sk = pshift(a_sk, mc, 1)
            b_sk = pshift(b_sk, mr, 1)
        return acc

    fn = shard_map(local, mesh=mesh,
                   in_specs=(ct_spec, ct_spec, cloud_spec),
                   out_specs=ct_spec, check_vma=False)
    return jax.jit(fn)(a, b, cloud)
