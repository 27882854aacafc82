"""Runtime context + hybrid-mode shims (reference parity layer).

The reference exposes QAT accelerator lifecycle and a QAT/CPU work-split
policy (py_ipclContext / py_ipclHybridControl / ipcl::HybridMode,
/root/reference/src/ipcl_python/bindings/include/ipcl_bindings.hpp:27-42,
ipcl_bindings.cpp:37-56).  Here the accelerator IS the modexp path, so
a literal QAT:CPU modexp ratio would only slow things down.  The honest
analog of the work-split knob is HOST/DEVICE PIPELINING: encryption
has a real host stage (fixed-point encode, limb packing, OS-entropy
digit sampling) and a device stage (the comb product chain), and
`setHybridMode` now controls how finely `PublicKey.encrypt` chunks a
batch so the host stage of chunk i+1 overlaps the (asynchronously
dispatched) device stage of chunk i:

    QAT                    -> 1 chunk (all-device-at-once, no overlap)
    OPTIMAL / PREF_QAT*    -> 4 chunks (overlap; device-leaning split)
    HALF                   -> 2 chunks
    PREF_IPP* / IPP        -> 8 chunks (host-leaning, finest pipelining)
    UNDEFINED              -> config default (no chunking)

`context` remains a device-selection shim: it reports whether an
accelerator backend is live (initialization is implicit in JAX).
"""

from __future__ import annotations

import enum


class hybridMode(enum.IntEnum):
    """Accelerator/CPU work-split ratios (values mirror ipcl::HybridMode)."""

    OPTIMAL = 0
    QAT = 1
    PREF_QAT90 = 2
    PREF_QAT80 = 3
    PREF_QAT70 = 4
    PREF_QAT60 = 5
    HALF = 6
    PREF_IPP60 = 7
    PREF_IPP70 = 8
    PREF_IPP80 = 9
    PREF_IPP90 = 10
    IPP = 11
    UNDEFINED = 12


# export_values() parity: enum members are reachable at module level too
OPTIMAL = hybridMode.OPTIMAL
QAT = hybridMode.QAT
HALF = hybridMode.HALF
IPP = hybridMode.IPP
UNDEFINED = hybridMode.UNDEFINED


class context:
    """Accelerator runtime lifecycle (py_ipclContext parity).

    `initializeContext("QAT")` in the reference spins up the QuickAssist
    runtime; here any accelerator choice maps onto JAX's default GPU
    backend (initialization is implicit in JAX), so these report state
    rather than mutate it.
    """

    _initialized = False
    _runtime_choice = None

    @staticmethod
    def initializeContext(runtime_choice: str) -> bool:
        context._initialized = True
        context._runtime_choice = runtime_choice
        return True

    @staticmethod
    def terminateContext() -> bool:
        context._initialized = False
        context._runtime_choice = None
        return True

    @staticmethod
    def isQATRunning() -> bool:
        """True when the GPU backend is JAX's default and the context is
        initialized."""
        if not context._initialized:
            return False
        from ..ops.montgomery import platform
        return platform() == "gpu"

    @staticmethod
    def isQATActive() -> bool:
        return context.isQATRunning()


_MODE_CHUNKS = {
    hybridMode.QAT: 1,
    hybridMode.OPTIMAL: 4,
    hybridMode.PREF_QAT90: 4, hybridMode.PREF_QAT80: 4,
    hybridMode.PREF_QAT70: 4, hybridMode.PREF_QAT60: 4,
    hybridMode.HALF: 2,
    hybridMode.PREF_IPP60: 8, hybridMode.PREF_IPP70: 8,
    hybridMode.PREF_IPP80: 8, hybridMode.PREF_IPP90: 8,
    hybridMode.IPP: 8,
}

# The reference's accelerator:CPU modexp ratio, made real (round 5):
# this fraction of each encrypt batch runs on the HOST bigint path in a
# worker thread, concurrently with the device program on the rest
# (api._hybrid_split_encrypt).  Active only once initializeContext has
# been called — exactly the reference's gate, where hybridMode only
# matters with the QAT runtime up (ipcl_bindings.cpp:37-56).  Forcing
# IPP routes 100% to host, faithfully reproducing "CPU library only"
# (slow on purpose, as on a QAT box).
_MODE_HOST_RATIO = {
    hybridMode.QAT: 0.0, hybridMode.OPTIMAL: 0.0,
    hybridMode.PREF_QAT90: 0.1, hybridMode.PREF_QAT80: 0.2,
    hybridMode.PREF_QAT70: 0.3, hybridMode.PREF_QAT60: 0.4,
    hybridMode.HALF: 0.5,
    hybridMode.PREF_IPP60: 0.6, hybridMode.PREF_IPP70: 0.7,
    hybridMode.PREF_IPP80: 0.8, hybridMode.PREF_IPP90: 0.9,
    hybridMode.IPP: 1.0,
}


class hybridControl:
    """Work-split policy (py_ipclHybridControl parity).

    Setting a mode configures the encrypt host/device pipelining depth
    (see module docstring); UNDEFINED restores the config default."""

    _mode = hybridMode.UNDEFINED

    @staticmethod
    def setHybridMode(mode: hybridMode) -> None:
        from . import config as _config
        hybridControl._mode = hybridMode(mode)
        chunks = _MODE_CHUNKS.get(hybridControl._mode)
        if chunks is not None:
            _config.set_config(encrypt_pipeline_chunks=chunks)
        ratio = _MODE_HOST_RATIO.get(hybridControl._mode)
        if ratio is not None:
            _config.set_config(encrypt_host_ratio=ratio)

    @staticmethod
    def setHybridOff() -> None:
        hybridControl.setHybridMode(hybridMode.IPP)

    @staticmethod
    def getHybridMode() -> hybridMode:
        return hybridControl._mode
