"""pailliercryptolib_python_tpu — batched Paillier cryptosystem framework.

A from-scratch JAX/XLA re-design of the capabilities of
intel/pailliercryptolib_python (reference surface: its
src/ipcl_python/__init__.py): the same public HE API
— PaillierKeypair / PaillierPublicKey / PaillierPrivateKey /
PaillierEncryptedNumber, fixed-point codec, binding-level containers,
context/hybrid controls — backed by batched limb-array kernels on the GPU
instead of AVX512IFMA C++ code.
"""

from .api import (
    PaillierKeypair,
    PaillierPublicKey,
    PaillierPrivateKey,
    PaillierEncryptedNumber,
    BNUtils,
)
from .fixedpoint import FixedPointNumber, FixedPointEndec
from .bindings.containers import (
    BigNumber,
    ipclBigNumber,
    ipclKeypair,
    ipclPublicKey,
    ipclPrivateKey,
    ipclPlainText,
    ipclCipherText,
)
from .utils.context import context, hybridControl, hybridMode
from .utils.config import get_config, set_config

__version__ = "2.0.0"

__all__ = [
    "PaillierKeypair",
    "PaillierPublicKey",
    "PaillierPrivateKey",
    "PaillierEncryptedNumber",
    "BNUtils",
    "FixedPointNumber",
    "FixedPointEndec",
    "BigNumber",
    "ipclBigNumber",
    "ipclKeypair",
    "ipclPublicKey",
    "ipclPrivateKey",
    "ipclPlainText",
    "ipclCipherText",
    "context",
    "hybridControl",
    "hybridMode",
    "get_config",
    "set_config",
]
