"""LWE ciphertext containers and sample algebra (batched, SoA).

The reference's coalesced `LweSample_16 {int* a; int* b; double* cv}`
(`gpuParallel/lwesamples.h:9-13`) is exactly a struct-of-arrays over a batch of
bits; here it becomes a pytree of jnp arrays with an arbitrary leading batch
shape, so every gate/circuit is batch-polymorphic by construction.

Sample algebra ports `gpuParallel/lwe-functions.cu:100-296` (add/sub/negate/
noiseless-trivial/addmul/submul) as pure functions with int32 wrap semantics.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class LweCiphertext:
    """Batch of LWE samples. a: int32[..., n], b: int32[...], cv: float32[...]."""
    a: jnp.ndarray
    b: jnp.ndarray
    cv: jnp.ndarray

    @property
    def batch_shape(self):
        return self.b.shape

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    def __getitem__(self, idx) -> "LweCiphertext":
        """Index the batch shape. Ellipsis/negative axes refer to batch dims;
        the trailing LWE dimension of `a` is preserved."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        a_idx = idx + (slice(None),) if any(i is Ellipsis for i in idx) else idx
        return LweCiphertext(self.a[a_idx], self.b[idx], self.cv[idx])

    def reshape(self, *batch_shape) -> "LweCiphertext":
        if len(batch_shape) == 1 and isinstance(batch_shape[0], (tuple, list)):
            batch_shape = tuple(batch_shape[0])
        return LweCiphertext(
            self.a.reshape(batch_shape + (self.a.shape[-1],)),
            self.b.reshape(batch_shape),
            self.cv.reshape(batch_shape),
        )


jax.tree_util.register_dataclass(
    LweCiphertext, data_fields=("a", "b", "cv"), meta_fields=()
)


def lwe_stack(cts, axis: int = 0) -> LweCiphertext:
    """Stack a list of ciphertext batches along a new batch axis.

    `axis` indexes the batch shape; negative axes count from the end of the
    batch shape (the `a` array has an extra trailing LWE dimension)."""
    a_axis = axis if axis >= 0 else axis - 1
    return LweCiphertext(
        jnp.stack([c.a for c in cts], axis=a_axis),
        jnp.stack([c.b for c in cts], axis=axis),
        jnp.stack([c.cv for c in cts], axis=axis),
    )


def lwe_take(ct: LweCiphertext, idx, axis: int = -1) -> LweCiphertext:
    """Gather batch entries along one batch axis with a (possibly
    multi-dimensional) static index array — ONE device op per field, replacing
    a Python loop of slices+stack (which dispatches hundreds of eager ops)."""
    idx = jnp.asarray(idx)
    a_axis = axis if axis >= 0 else axis - 1
    return LweCiphertext(
        jnp.take(ct.a, idx, axis=a_axis),
        jnp.take(ct.b, idx, axis=axis),
        jnp.take(ct.cv, idx, axis=axis),
    )


def lwe_concat(cts, axis: int = 0) -> LweCiphertext:
    a_axis = axis if axis >= 0 else axis - 1
    return LweCiphertext(
        jnp.concatenate([c.a for c in cts], axis=a_axis),
        jnp.concatenate([c.b for c in cts], axis=axis),
        jnp.concatenate([c.cv for c in cts], axis=axis),
    )


# ------------------------------------------------------------------ algebra

def noiseless_trivial(mu, n: int, batch_shape=()) -> LweCiphertext:
    """(0, mu) (ref lwe-functions.cu lweNoiselessTrivial)."""
    mu = jnp.broadcast_to(jnp.asarray(mu, jnp.int32), batch_shape)
    return LweCiphertext(
        jnp.zeros(batch_shape + (n,), jnp.int32),
        mu,
        jnp.zeros(batch_shape, jnp.float32),
    )


def lwe_add(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(x.a + y.a, x.b + y.b, x.cv + y.cv)


def lwe_sub(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(x.a - y.a, x.b - y.b, x.cv + y.cv)


def lwe_negate(x: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(-x.a, -x.b, x.cv)


def lwe_add_mul(x: LweCiphertext, p: int, y: LweCiphertext) -> LweCiphertext:
    """x + p*y (ref lweAddMulTo)."""
    pi = jnp.int32(p)
    return LweCiphertext(x.a + pi * y.a, x.b + pi * y.b, x.cv + float(p * p) * y.cv)


def lwe_sub_mul(x: LweCiphertext, p: int, y: LweCiphertext) -> LweCiphertext:
    pi = jnp.int32(p)
    return LweCiphertext(x.a - pi * y.a, x.b - pi * y.b, x.cv + float(p * p) * y.cv)
