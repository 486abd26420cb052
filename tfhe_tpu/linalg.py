"""Encrypted vector and matrix operations.

Ports the reference's L7 vector/matrix layer (`gpuParallel/main.cu:1033-1355,
2223-2644`, `matrixUtility.cu`) to batched circuits. Because every arith
circuit already accepts leading batch axes, "vector" ops are the same circuits
with batch = vector length (the reference's `_vector` kernels), and matrix ops
are reshapes + one big batch.

Shapes: an encrypted vector of L n-bit numbers is an LweCiphertext with batch
shape [L, nbits]; a matrix is [R, C, nbits].
"""
from __future__ import annotations

from . import arith, gates
from .core.lwe import LweCiphertext, lwe_stack


def vector_add(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Elementwise vector addition (ref BOOTS_vectorAddition, main.cu:1304-1355)."""
    return arith.add(a, b, cloud)


def vector_mul(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Elementwise vector multiplication (ref BOOTS_vectorMultiplication,
    main.cu:1746-1865): all L*nbits^2 partial-product ANDs in one bootstrap."""
    return arith.mul(a, b, cloud)


@arith.circuit
def vector_sum(v: LweCiphertext, cloud) -> LweCiphertext:
    """Sum of a vector of numbers (ref BOOTS_Add_vector, main.cu:1033-1136),
    via the carry-save 3:2 reduction (arith._csa_reduce_rows — same bootstrap
    count as the reference's pairwise tree, ~nbits/2 x fewer serial stages).
    v: [..., L, nbits] -> [..., nbits]."""
    return arith._csa_reduce_rows(v, cloud)


def matrix_add(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Elementwise matrix addition (ref BOOTS_matrixAddition, main.cu:2223-2275)."""
    return arith.add(a, b, cloud)


@arith.circuit
def matmul(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Matrix multiply: ALL r*c2*c element products' partial-product ANDs as
    ONE bootstrap batch, then ONE fused carry-save contraction per output
    element (`arith.dot`) — the reference multiplies every element pair and
    log-tree-accumulates the results (ref BOOTS_matrixMultiplication,
    main.cu:2342-2462 with the matMul_prepareLeftMat/RightMat duplication,
    matrixUtility.cu:65-96); the fusion skips its K per-product carry chains.

    a: [R, K, nbits]; b: [K, C, nbits] -> [R, C, nbits].
    """
    R, K = a.batch_shape[0], a.batch_shape[1]
    C = b.batch_shape[1]
    # left[i, j, k] = a[i, k]; right[i, j, k] = b[k, j]
    a_exp = lwe_stack([a] * C, axis=1)            # [R, C, K, nbits]
    b_t = lwe_stack([b[:, j] for j in range(C)], axis=0)   # [C, K, nbits]
    b_exp = lwe_stack([b_t] * R, axis=0)          # [R, C, K, nbits]
    return arith.dot(a_exp, b_exp, cloud)         # fused contraction over K


@arith.circuit
def cannon_matmul(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Cannon's algorithm over the element grid (ref BOOTS_CannonsAlgo,
    main.cu:2590-2644 with leftRotate/upRotate :2531-2557): pre-skew, then D
    rounds of elementwise multiply + accumulate + neighbor rotations.

    Single-chip version (rotations are array rolls); the mesh version with
    ppermute lives in tfhe_tpu.parallel.cannon. a, b: [D, D, nbits].

    The per-round multiply+accumulate is kept in CARRY-SAVE form: each round
    contributes its triangle partial-product ANDs (one bootstrap batch) to a
    per-element bit pool, and a single Wallace compression + one ripple add
    run after the last round — the reference accumulates with a full adder
    every round (main.cu:2618-2631), paying D carry chains per element.
    """
    import jax.numpy as jnp
    import numpy as np
    from .core.lwe import lwe_take, lwe_concat
    D = a.batch_shape[0]
    nbits = a.batch_shape[-1]

    def roll_rows(x: LweCiphertext, shifts_per_row):
        rows = []
        for i in range(D):
            rows.append(LweCiphertext(
                jnp.roll(x.a[i], -shifts_per_row(i), axis=0),
                jnp.roll(x.b[i], -shifts_per_row(i), axis=0),
                jnp.roll(x.cv[i], -shifts_per_row(i), axis=0)))
        return lwe_stack(rows, axis=0)

    def roll_cols(x: LweCiphertext, shifts_per_col):
        cols = []
        for j in range(D):
            cols.append(LweCiphertext(
                jnp.roll(x.a[:, j], -shifts_per_col(j), axis=0),
                jnp.roll(x.b[:, j], -shifts_per_col(j), axis=0),
                jnp.roll(x.cv[:, j], -shifts_per_col(j), axis=0)))
        return lwe_stack(cols, axis=1)

    # initial skew: row i of A left-rotated by i, col j of B up-rotated by j
    a_sk = roll_rows(a, lambda i: i)
    b_sk = roll_cols(b, lambda j: j)
    ja, ib, cols = arith._mul_triangle(nbits)
    sep = arith._septet_enabled(nbits, cloud.params)
    mu_pp = gates.MU16 if sep else gates.MU
    pools = []
    for _ in range(D):
        lhs = lwe_take(a_sk, ja, axis=-1)          # [D, D, P]
        rhs = lwe_take(b_sk, ib, axis=-1)
        pools.append(gates.gate2("AND", lhs, rhs, cloud, mu=mu_pp))
        a_sk = roll_rows(a_sk, lambda i: 1)
        b_sk = roll_cols(b_sk, lambda j: 1)
    pool = lwe_concat(pools, axis=-1)              # [D, D, D*P]
    return arith._wallace_sum_bits(
        pool, np.tile(cols, D), nbits, cloud,
        amp=np.full(D * len(cols), 16 if sep else 8))
