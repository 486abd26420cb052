"""tfhe_tpu — a batched Torus Fully Homomorphic Encryption framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the reference
CPU/GPU TFHE library (toufique-morshed/CPU-GPU-TFHE): gate bootstrapping,
boolean gate API, integer arithmetic circuits, vector/matrix ops, and
multi-device scaling over device meshes.

Layer map (SURVEY.md section 1 -> this package):
  L0 numerics        -> tfhe_tpu.numeric
  L1/L2 poly + FFT   -> tfhe_tpu.ntt (exact CRT NTT) + tfhe_tpu.ops (CUDA kernel)
  L3/L4/L5 core      -> tfhe_tpu.core (lwe, keys, bootstrap, crypt)
  L6 gates           -> tfhe_tpu.gates
  L7 arithmetic      -> tfhe_tpu.arith, tfhe_tpu.linalg, tfhe_tpu.cipher
  L8 apps/CLI        -> tfhe_tpu.apps
  serialization      -> tfhe_tpu.io
  parallel scaling   -> tfhe_tpu.parallel
"""

from .params import TfheParams, PARAMS_110, PARAMS_TOY, PARAMS_SMALL, PARAMS_SMALL_NOISY
from .core.keys import keygen, SecretKeySet, CloudKey
from .core.lwe import LweCiphertext
from .core.crypt import encrypt_bits, decrypt_bits, decrypt_phase, lwe_encrypt, lwe_phase
from . import gates
from . import ntt
from . import numeric
from . import arith
from . import linalg
from . import io
from .cipher import CipherInt

__version__ = "0.1.0"
