#!/usr/bin/env python
"""Analytic noise-budget certificate for the worst circuit DAGs.

Replays the production circuits through the exact phase simulator
(tfhe_tpu/utils/phasesim.py): every bootstrap-input image's worst-case margin
(its phase-lattice unit) and tracked variance are recorded, and the failure
certificate is the union bound sum_i erfc(z_i / sqrt 2) over the whole op.

Three per-sample variance models (NOISE.md derives them):
  tracked  — the framework's own worst-case-digit accounting (the reference's
             cv discipline): conservative by ~2.5x in variance.
  average  — average-case digit variance (rigorous for computationally
             uniform ciphertexts, concentration over ~2e6 digit terms).
  measured — per-sample variance measured from real ciphertexts (pinned in
             phasesim.SAMPLE_VAR_MEASURED_110).

Also validates each circuit's exact DAG at PARAMS_110 (the simulated decrypt
must equal the plaintext op), and counts bootstrap images per op — the
circuit-size numbers NOISE.md cites.

Usage: python tools/noise_budget.py [--quick] [--json OUT]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from tfhe_tpu.params import PARAMS_110
from tfhe_tpu.utils import phasesim as ps
from tfhe_tpu import arith, gates
from tfhe_tpu.config import enable_compile_cache

GATE_BUDGET = 2.0 ** -25   # classic per-gate failure discipline (paper SIII)


def _models(params):
    return {
        "tracked": ps.sample_var_tracked(params),
        "average": ps.sample_var_average(params),
        "measured": ps.SAMPLE_VAR_MEASURED_110,
    }


def run_circuit(builder, params, sample_var, trials=2, seed=11):
    """builder(sim, rng) -> (result_ct, expect_fn(got)->bool)"""
    sims = []
    rng = np.random.RandomState(seed)
    for _ in range(trials):
        with ps.PhaseSim(params, sample_var=sample_var) as sim:
            out, check = builder(sim, rng)
            assert check(sim), "exact-DAG decrypt mismatch"
            if out is not None:
                sim.final_record(out)
            sims.append(sim)
    return sims


# ---------------------------------------------------------------- circuits

def mk_mul(nbits):
    def build(sim, rng):
        av = int(rng.randint(0, 1 << min(nbits, 30)))
        bv = int(rng.randint(0, 1 << min(nbits, 30)))
        a, b = sim.encrypt_int(av, nbits), sim.encrypt_int(bv, nbits)
        out = arith.mul(a, b, sim.cloud)
        want = (av * bv) % (1 << nbits)
        return out, lambda s: int(s.decrypt_int(out, signed=False)) % (1 << nbits) == want
    return build


def mk_dot(K, nbits):
    def build(sim, rng):
        av = rng.randint(0, 1 << (nbits - 1), size=K)
        bv = rng.randint(0, 1 << (nbits - 1), size=K)
        a = sim.encrypt_int(av, nbits).reshape((K, nbits))
        b = sim.encrypt_int(bv, nbits).reshape((K, nbits))
        out = arith.dot(a, b, sim.cloud)
        want = int(np.sum(av.astype(object) * bv.astype(object))) % (1 << nbits)
        return out, lambda s: int(s.decrypt_int(out, signed=False)) % (1 << nbits) == want
    return build


def mk_div(nbits):
    def build(sim, rng):
        av = int(rng.randint(1, 1 << (nbits - 2)))
        bv = int(rng.randint(1, 1 << (nbits // 2)))
        a, b = sim.encrypt_int(av, nbits), sim.encrypt_int(bv, nbits)
        out = arith.div(a, b, sim.cloud)
        return out, lambda s: int(s.decrypt_int(out)) == av // bv
    return build


def mk_add(nbits):
    def build(sim, rng):
        av = int(rng.randint(0, 1 << (nbits - 1)))
        bv = int(rng.randint(0, 1 << (nbits - 1)))
        a, b = sim.encrypt_int(av, nbits), sim.encrypt_int(bv, nbits)
        out = arith.add(a, b, sim.cloud)
        want = (av + bv) % (1 << nbits)
        return out, lambda s: int(s.decrypt_int(out, signed=False)) % (1 << nbits) == want
    return build


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="skip the 32-bit and K=16 DAGs")
    ap.add_argument("--json", default="NOISE_BUDGET.json")
    args = ap.parse_args()
    params = PARAMS_110

    circuits = [
        ("add32_ripple", mk_add(32), {}),
        ("mul16_septet", mk_mul(16), {"TFHE_TPU_SEPTET": "1"}),
        ("mul16_fa", mk_mul(16), {"TFHE_TPU_SEPTET": "0"}),
        ("div16", mk_div(16), {}),
    ]
    if not args.quick:
        circuits += [
            ("mul32_septet", mk_mul(32), {"TFHE_TPU_SEPTET": "1"}),
            ("dot16x16_septet", mk_dot(16, 16), {"TFHE_TPU_SEPTET": "1"}),
        ]

    models = _models(params)
    print(f"per-sample variance models: " +
          ", ".join(f"{k}={v:.3e}" for k, v in models.items()))
    print(f"mod-switch image variance: {ps.var_modswitch(params):.3e}")
    print(f"classic per-gate budget: 2^-25 = {GATE_BUDGET:.2e}\n")

    results = {"models": {k: float(v) for k, v in models.items()},
               "var_modswitch": ps.var_modswitch(params),
               "gate_budget": GATE_BUDGET, "circuits": {}}
    for name, builder, env in circuits:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            row = {}
            for mname, svar in models.items():
                sims = run_circuit(builder, params, svar)
                rep = ps.analyze(sims, params, label=name)
                row[mname] = rep
            n_img = row["tracked"]["images_live"]
            budget = n_img * GATE_BUDGET
            print(f"{name}: {n_img} live images ({row['tracked']['images_total']}"
                  f" total, {row['tracked']['bootstrap_calls']} kernel calls); "
                  f"op budget {budget:.2e}")
            for mname in models:
                r = row[mname]
                verdict = "PASS" if r["sum_pfail"] <= budget else "over-budget"
                print(f"  {mname:9s} min_z={r['min_z']:5.2f} "
                      f"P(op fails)<={r['sum_pfail']:.2e}  [{verdict}]")
            row["budget"] = budget
            results["circuits"][name] = row
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    with open(args.json, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\nwrote {args.json}")


if __name__ == "__main__":
    main()
