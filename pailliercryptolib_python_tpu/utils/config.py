"""Runtime configuration + per-key device-table lifecycle.

The reference's only runtime knobs are `context.initializeContext(str)`
and `hybridControl.setHybridMode(enum)` (SURVEY.md §5, config row —
bindings/include/ipcl_bindings.hpp:27-42); everything else is a CMake
compile option.  This framework needs real runtime knobs because its
resource trade-offs are runtime-sized: the fixed-base comb table that
accelerates DJN encryption costs ``ceil(randbits/w) * L * 2^w * 4`` bytes
of device memory *per key* (~360 MB at 2048-bit/w=12), so the window must
adapt to the memory budget and tables of retired keys must be evicted.

Knobs (env override in parentheses):
  * comb_window_accel / comb_window_cpu  (PAILLIER_COMB_WINDOW)
        maximum fixed-base comb window; the actual per-key window shrinks
        until the table fits ``comb_hbm_budget_bytes // 2`` so at least
        two keys' tables can coexist at full speed.
  * comb_hbm_budget_bytes              (PAILLIER_COMB_HBM_BUDGET)
        total device memory allowed across ALL cached comb tables;
        least-recently used tables are evicted when a new build would
        exceed it.
  * exp_window                         (PAILLIER_EXP_WINDOW)
        fixed window for per-element modexp (ct*pt, CRT decrypt).
  * mesh_hosts / mesh_chips            (PAILLIER_MESH_SHAPE="H,C")
        default mesh shape for parallel.mesh.make_mesh.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclasses.dataclass
class Config:
    comb_window_accel: int = _env_int("PAILLIER_COMB_WINDOW", 12)
    comb_window_cpu: int = _env_int("PAILLIER_COMB_WINDOW", 8)
    comb_hbm_budget_bytes: int = _env_int(
        "PAILLIER_COMB_HBM_BUDGET", 4 * 1024**3)
    exp_window: int = _env_int("PAILLIER_EXP_WINDOW", 4)
    # matmul working-set bound: max ciphertext columns materialized per
    # chunk of the (m*n*k)-wide matmul layout (32768 cols ~ 34 MB at
    # 2048-bit).  Soft bound: one reduction group (n columns) is the
    # indivisible unit, so when n alone exceeds this value a chunk still
    # materializes the full n columns of that one group.  The reference
    # never batches this wide (per-element Python loops,
    # ipcl_python.py:829-880) so it pays time instead.
    matmul_chunk_columns: int = _env_int("PAILLIER_MATMUL_CHUNK", 1 << 15)
    # CRT-decrypt number system: "rns" (RNS-Montgomery, ops/rns.py),
    # "limb" (positional-limb kernels), or "auto" (rns — both are exact;
    # the knob exists to A/B and to fall back if a platform misbehaves).
    decrypt_engine: str = os.environ.get("PAILLIER_DECRYPT_ENGINE", "auto")
    # fixed window for the RNS shared-exponent chain (table = 2^w states)
    rns_exp_window: int = _env_int("PAILLIER_RNS_WINDOW", 5)
    # DJN encrypt engine: "auto" (RNS streamed comb product on the GPU,
    # where it is the faster device program — 37.6 vs 48.9 ms for the
    # limb comb at 2048-bit, B=16384 on an H100 at 700 W — limb
    # elsewhere), "rns" (force, e.g. for CPU equality tests), "limb".
    # The RNS path keeps the per-key comb table as RNS states (~2x the
    # comb's memory) and each encrypt window is one RNS product instead
    # of a positional-limb modmul.
    encrypt_engine: str = os.environ.get("PAILLIER_ENCRYPT_ENGINE", "auto")
    # Fixed-shape ct*pt: pad every plaintext exponent to the full mod-n
    # window count and run the negative-column inversion pass over the
    # WHOLE batch unconditionally, so device timing is independent of
    # plaintext magnitude and sign (closes the timing side channel of
    # the leading-zero-window skip / flagged-column gather; the
    # reference's Python layer leaks the same way).  Costs ~the full
    # modexp even for small plaintexts plus one batch inversion per mul.
    fixed_shape_ops: bool = os.environ.get("PAILLIER_FIXED_SHAPE") == "1"
    # device-batched base-2 Miller-Rabin in keygen: "1" always, "auto" on
    # the GPU for >= 1024-bit primes, "0" host-only (the default: the
    # device path pays a compile and one dispatch per squaring, and is
    # correctness-tested either way).
    keygen_device: str = os.environ.get("PAILLIER_KEYGEN_DEVICE", "0")
    # concurrent p/q prime searches in a persistent 2-process pool:
    # "auto" (>= 2048-bit keys), "1" (always), "0" (serial).  The GIL
    # serializes CPython bigint pow, so real overlap needs processes;
    # the pool is lazy and reused across keygens.
    keygen_parallel: str = os.environ.get("PAILLIER_KEYGEN_PARALLEL",
                                          "auto")
    # encrypt host/device pipelining depth (1 = no chunking); the
    # hybridControl.setHybridMode parity knob maps onto this
    # (utils/context.py).  Chunk i+1's host encode/pack/entropy overlaps
    # chunk i's asynchronously dispatched device program.
    encrypt_pipeline_chunks: int = _env_int("PAILLIER_ENC_CHUNKS", 1)
    # fraction of each encrypt batch routed to the HOST bigint path,
    # running CONCURRENTLY (worker thread; CPython pow waits while the
    # main thread blocks on the device) — the reference's QAT:CPU
    # work-split made real (hybridMode PREF_IPP*/HALF/IPP set this;
    # active only after context.initializeContext, like the reference's
    # QAT runtime gate).  OPTIMAL/QAT keep 0.0 — the knob exists for
    # parity and for hosts where the device is busy.
    encrypt_host_ratio: float = float(
        os.environ.get("PAILLIER_HOST_RATIO", "0") or 0)
    mesh_hosts: int | None = None
    mesh_chips: int | None = None

    def __post_init__(self):
        shape = os.environ.get("PAILLIER_MESH_SHAPE")
        if shape and self.mesh_hosts is None:
            h, c = shape.split(",")
            self.mesh_hosts, self.mesh_chips = int(h), int(c)


_config = Config()
_lock = threading.Lock()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    """Update knobs in place; returns the live config."""
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise ValueError(f"set_config: unknown knob {k!r}")
        setattr(_config, k, v)
    return _config


def comb_table_bytes(randbits: int, L: int, window: int) -> int:
    """HBM footprint of a fixed-base comb table (uint32 entries)."""
    n_win = -(-randbits // window)
    return n_win * L * (1 << window) * 4


def choose_comb_window(randbits: int, L: int, max_window: int) -> int:
    """Largest window <= max_window whose table fits half the HBM budget
    (so two keys' tables coexist without thrash).  Never below 2."""
    cap = max(1, get_config().comb_hbm_budget_bytes // 2)
    for w in range(max_window, 2, -1):
        if comb_table_bytes(randbits, L, w) <= cap:
            return w
    return 2


class _CombRegistry:
    """LRU registry of live per-key comb tables, bounded by the HBM budget.

    Owners (PublicContext instances) register their table size on build;
    when the running total would exceed ``comb_hbm_budget_bytes`` the
    least-recently-used owners are asked to drop their tables (the device
    buffers free once unreferenced).  Touch on every use keeps hot keys
    resident.
    """

    def __init__(self):
        self._entries: OrderedDict[int, tuple] = OrderedDict()  # id -> (owner, bytes)
        self._total = 0

    def register(self, owner, nbytes: int) -> None:
        with _lock:
            key = id(owner)
            if key in self._entries:
                self._total -= self._entries.pop(key)[1]
            budget = get_config().comb_hbm_budget_bytes
            while self._entries and self._total + nbytes > budget:
                _, (old_owner, old_bytes) = self._entries.popitem(last=False)
                self._total -= old_bytes
                old_owner._drop_comb()
            self._entries[key] = (owner, nbytes)
            self._total += nbytes

    def touch(self, owner) -> None:
        with _lock:
            key = id(owner)
            if key in self._entries:
                self._entries.move_to_end(key)

    def unregister(self, owner) -> None:
        with _lock:
            ent = self._entries.pop(id(owner), None)
            if ent is not None:
                self._total -= ent[1]

    @property
    def total_bytes(self) -> int:
        return self._total

    def __len__(self):
        return len(self._entries)


comb_registry = _CombRegistry()
