"""Central routing configuration — the ONE module that reads ``os.environ``.

Every dispatch policy in the framework (which circuit family, whether a
whole circuit compiles into one program) resolves through this module, so a
policy can never silently disagree between call sites or processes: the
defaults live here as code, the env vars are *overrides only*, and
tests/simulators override programmatically via :func:`overrides`.

The reference has no configuration system at all — constants are compiled in
(``gpuParallel/boot-gates.cu:2120-2124``) and experiments are chosen by
(un)commenting lines (``gpuParallel/main.cu:2771-2787``).

| flag                  | default                         |
|-----------------------|---------------------------------|
| TFHE_TPU_CIRCUIT_JIT  | on when the backend is not CPU  |
| TFHE_TPU_LOOKAHEAD    | off (ripple adders everywhere)  |
| TFHE_TPU_SEPTET       | off (full-adder Dadda tree)     |
| TFHE_TPU_NOISE_MODEL  | average                         |
| JAX_COMPILATION_CACHE_DIR | <checkout>/.jax_cache       |
| REF_DIR               | reference checkout for the differential oracle build |

The circuit-family defaults are not yet measured on the H100 (PERF.md).
"""
from __future__ import annotations

import contextlib
import os

# ---------------------------------------------------------------- raw access

_OVERRIDES: dict = {}


def flag(name: str, default: str = "auto") -> str:
    """Resolve a flag: programmatic override > environment > default."""
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    return os.environ.get(name, default)


@contextlib.contextmanager
def overrides(**kv):
    """Programmatic flag overrides (tests / the phase simulator).

    ``overrides(TFHE_TPU_SEPTET="1")`` wins over the environment for the
    duration of the context. A value of None removes an active override.
    """
    saved = {}
    for k, v in kv.items():
        saved[k] = _OVERRIDES.get(k, _MISSING)
        if v is None:
            _OVERRIDES.pop(k, None)
        else:
            _OVERRIDES[k] = str(v)
    try:
        yield
    finally:
        for k, old in saved.items():
            if old is _MISSING:
                _OVERRIDES.pop(k, None)
            else:
                _OVERRIDES[k] = old


_MISSING = object()


# ------------------------------------------------------------- resolved policies

def lookahead_enabled(numbers: int, nbits: int) -> bool:
    """Parallel-prefix (Kogge-Stone) adder vs ripple — ripple by default.

    Prefix spends ~5x the bootstraps of a ripple to cut the serial depth
    ~3x. Under whole-circuit jit the bootstrap volume is the whole cost, and
    circuits that chain adds (division) expose it directly, so ripple is the
    default everywhere (not measured on the H100). TFHE_TPU_LOOKAHEAD=1
    forces the prefix form (still exercised by the A/B rows and tests)."""
    v = flag("TFHE_TPU_LOOKAHEAD")
    if v in ("0", "1"):
        return v == "1"
    return False


def septet_enabled(nbits: int) -> bool:
    """7:3 compressor levels in carry-save reductions — OFF by default.

    The septet removes a bit for 0.75 bootstraps against the full adder's
    2.0 but needs extra recode levels, and its ±1/16 domain has the thinner
    noise margin (NOISE.md: z >= 12.3 for the full-adder Dadda tree under
    every accounting model vs the septet domain's 5.7/6.4 measured / 4.1
    worst-case-constant). So the default is the ±1/8 full-adder tree at
    every width (not measured on the H100).
    TFHE_TPU_SEPTET=1 opts in — with one exception either way: bits already
    encoded at ±1/16 force the septet ENGINE regardless, because the FA tree
    cannot consume MU16 bits (see arith._wallace_sum_bits); its planner still
    caps group liveness at phasesim.max_live16."""
    v = flag("TFHE_TPU_SEPTET")
    if v in ("0", "1"):
        return v == "1"
    return False


def circuit_jit_enabled() -> bool:
    """Whole-circuit jit (arith.circuit): trace an ENTIRE integer circuit —
    every gate batch, kernel launch and inter-stage affine — into ONE XLA
    program, so the per-gate dispatch from Python disappears and the
    kernels run back to back on the device with no host round-trips.

    Auto = on for an accelerator backend, off on CPU, where the per-shape
    XLA compile of a many-hundred-kernel program would dwarf the eager run
    (the H100 A/B is in PERF.md). TFHE_TPU_CIRCUIT_JIT=0/1 forces."""
    v = flag("TFHE_TPU_CIRCUIT_JIT")
    if v in ("0", "1"):
        return v == "1"
    import jax
    return jax.default_backend() != "cpu"


def policy_fingerprint() -> tuple:
    """Every flag that changes a circuit's TRACE structure, used as part of
    the whole-circuit jit cache key so a runtime flag flip (the A/B benches
    do this) retraces instead of silently reusing the old route."""
    return (flag("TFHE_TPU_LOOKAHEAD"), flag("TFHE_TPU_SEPTET"),
            flag("TFHE_TPU_NOISE_MODEL", "average"))


def noise_model() -> str:
    """Noise-accounting model the compressor planner certifies against
    (NOISE.md §2): "average" (default — the physically realized per-sample
    variance, rigorous for uniform ciphertexts and confirmed by sampled
    ciphertexts to 9%), "measured" (the constant sampled from real
    ciphertexts, which are bit-identical on every device), or "tracked" (the
    worst-case-digit constants the runtime cv bookkeeping carries — the
    loose bound the reference also uses but never audits). The planner caps
    every ±1/16 image's live-input count so its z-score under the ACTIVE
    model stays >= 5 (phasesim.max_live16); under "tracked" that demotes
    7-way septets (z = 4.1) to the full-adder domain (z >= 12.3).
    TFHE_TPU_NOISE_MODEL overrides."""
    v = flag("TFHE_TPU_NOISE_MODEL", "average")
    if v not in ("average", "measured", "tracked"):
        raise ValueError(f"TFHE_TPU_NOISE_MODEL={v!r}: want average|measured|tracked")
    return v


def ref_dir() -> str:
    """Location of the reference checkout (differential-oracle build)."""
    return flag("REF_DIR", "/root/reference/gpuParallel")


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the fixed <checkout>/.jax_cache
    (a fixed path, because the path is part of the cache key)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir().
    Every entry point (bench, smoke, apps, tools, tests) calls this once."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
