"""Drop-in import alias: `import ipcl_python` -> pailliercryptolib_python_tpu.

Mirrors the reference package surface (/root/reference/src/ipcl_python/
__init__.py:1-11) so existing ipcl_python users switch without code
changes.
"""

from pailliercryptolib_python_tpu import (  # noqa: F401
    PaillierKeypair,
    PaillierPublicKey,
    PaillierPrivateKey,
    PaillierEncryptedNumber,
    BNUtils,
    context,
    hybridControl,
    hybridMode,
    ipclBigNumber,
    ipclKeypair,
    ipclPublicKey,
    ipclPrivateKey,
    ipclPlainText,
    ipclCipherText,
)
from pailliercryptolib_python_tpu import api as ipcl_python  # noqa: F401
