"""The platform query, the choices that read it, the GPU product's
wrapper, and the op-count window rule.

The CUDA kernel itself runs only on a card (test_cuda_product_matches_jnp,
marked gpu); everything around it — argument shaping, broadcasting, odd
batch widths, which product a platform gets — is checked here on the CPU
with the kernel replaced by a Python-int model of its contract.
"""

import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pailliercryptolib_python_tpu.models import paillier as sch
from pailliercryptolib_python_tpu.ops import cuda_mont, limb
from pailliercryptolib_python_tpu.ops import montgomery as mg
from pailliercryptolib_python_tpu.utils import config as cfg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

rng = random.Random(17)


def _odd_modulus(L):
    """Odd modulus with R = 2^(16L) > 4n."""
    return rng.getrandbits(16 * L - 2) | 1 | (1 << (16 * L - 3))


def _mont_ref(a: int, b: int, n: int, L: int) -> int:
    """(a*b + M*n) / R with R = 2^(16L), M = -a*b*n^-1 mod R: the value
    every Montgomery product of this package returns."""
    R = 1 << (16 * L)
    M = -a * b * pow(n, -1, R) % R
    return (a * b + M * n) // R


def _cols(arr, B):
    """Column ints of an (L, 1|B) limb array, broadcast to B columns."""
    ints = limb.limbs_to_ints(np.asarray(arr))
    return ints * B if len(ints) == 1 else ints


def _fake_kernel(calls):
    """Stand-in for the FFI call: records its arguments and computes the
    kernel's contract column by column in Python ints."""
    def fake(a, b, n, B):
        calls.append((a.shape, b.shape, n.shape, a.dtype, b.dtype,
                      n.dtype, B))
        L = a.shape[0]
        out = [_mont_ref(x, y, m, L) for x, y, m in
               zip(_cols(a, B), _cols(b, B), _cols(n, B))]
        return jnp.asarray(limb.ints_to_limbs(out, L))
    return fake


# -- the platform query -------------------------------------------------------

def test_platform_is_cpu_in_the_test_suite():
    assert mg.platform() == "cpu"


@pytest.mark.parametrize("devices, message", [
    ([], "no device"),
    ([types.SimpleNamespace(platform="rocm")], "unsupported"),
    ([types.SimpleNamespace(platform="METAL")], "unsupported"),
])
def test_platform_raises_without_a_supported_device(monkeypatch, devices,
                                                    message):
    monkeypatch.setattr(jax, "devices", lambda: devices)
    with pytest.raises(RuntimeError, match=message):
        mg.platform()


def test_platform_reports_gpu(monkeypatch):
    monkeypatch.setattr(jax, "devices",
                        lambda: [types.SimpleNamespace(platform="gpu")])
    assert mg.platform() == "gpu"


# -- choices that read it -----------------------------------------------------

@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(mg, "platform", lambda: "gpu")


def test_mont_mul_takes_the_cuda_kernel_on_gpu(monkeypatch, on_gpu):
    calls = []
    monkeypatch.setattr(cuda_mont, "_ffi_mont_mul", _fake_kernel(calls))
    n = _odd_modulus(5)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [rng.randrange(2 * n) for _ in range(6)]
    ys = [rng.randrange(2 * n) for _ in range(6)]
    a = jnp.asarray(limb.ints_to_limbs(xs, ctx.num_limbs))
    b = jnp.asarray(limb.ints_to_limbs(ys, ctx.num_limbs))
    got = mg.mont_mul(a, b, ctx)
    assert len(calls) == 1
    assert calls[0][2] == (ctx.num_limbs, 1)        # n_limbs, shared
    want = mg._mont_mul_jnp(a, b, ctx)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_mont_mul_takes_jnp_on_cpu(monkeypatch):
    def boom(*args):
        raise AssertionError("the CUDA kernel must not run on the CPU")
    monkeypatch.setattr(cuda_mont, "_ffi_mont_mul", boom)
    n = _odd_modulus(4)
    ctx = mg.MontCtx.for_modulus(n)
    a = jnp.asarray(limb.ints_to_limbs([3, 5], ctx.num_limbs))
    got = limb.limbs_to_ints(np.asarray(mg.mont_mul(a, a, ctx)))
    assert got == [_mont_ref(3, 3, n, ctx.num_limbs),
                   _mont_ref(5, 5, n, ctx.num_limbs)]


@pytest.mark.parametrize("platform, engine, rns", [
    ("gpu", "auto", True), ("cpu", "auto", False),
    ("gpu", "limb", False), ("cpu", "rns", True),
])
def test_encrypt_engine_choice(monkeypatch, platform, engine, rns):
    monkeypatch.setattr(mg, "platform", lambda: platform)
    assert sch._rns_encrypt_engine(engine) is rns


@pytest.mark.parametrize("platform, knob", [
    ("gpu", "comb_window_accel"), ("cpu", "comb_window_cpu")])
def test_comb_window_cap_by_platform(monkeypatch, platform, knob):
    monkeypatch.setattr(mg, "platform", lambda: platform)
    kd = fixed_key_ints(256)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    # a 256-bit key's tables are far below the budget: the cap binds
    assert pub.comb_window == getattr(cfg.get_config(), knob)


@pytest.mark.parametrize("platform, knob, bits, bulk", [
    ("gpu", "auto", 1024, True), ("gpu", "auto", 512, False),
    ("cpu", "auto", 1024, False), ("gpu", "0", 1024, False),
    ("cpu", "1", 256, True),
])
def test_keygen_device_gate(monkeypatch, platform, knob, bits, bulk):
    monkeypatch.setattr(mg, "platform", lambda: platform)
    monkeypatch.setattr(cfg.get_config(), "keygen_device", knob)
    seen = []

    def first_prime(base, mask, nbits, use_device):
        seen.append(use_device)
        return 7
    monkeypatch.setattr(sch, "_primes_from_window", first_prime)
    assert sch.generate_prime(bits) == 7
    assert seen == [bulk]


def test_keygen_device_default_is_host():
    assert cfg.Config().keygen_device == "0"


# -- the GPU product's wrapper ------------------------------------------------

@pytest.mark.parametrize("B", [1, 8, 37, 128])
@pytest.mark.parametrize("a_cols, b_cols, n_cols", [
    ("B", "B", "1"), ("B", "1", "1"), ("1", "B", "B"), ("B", "B", "B"),
])
def test_wrapper_broadcast_and_odd_widths(monkeypatch, B, a_cols, b_cols,
                                          n_cols):
    calls = []
    monkeypatch.setattr(cuda_mont, "_ffi_mont_mul", _fake_kernel(calls))
    L = 5
    width = {"1": 1, "B": B}
    ns = [_odd_modulus(L) for _ in range(width[n_cols])]
    n_cols_ints = ns * B if len(ns) == 1 else ns
    a = [rng.randrange(2 * ns[0 if len(ns) == 1 else j])
         for j in range(width[a_cols])]
    b = [rng.randrange(2 * ns[0 if len(ns) == 1 else j])
         for j in range(width[b_cols])]
    arr = lambda xs: jnp.asarray(limb.ints_to_limbs(xs, L))  # noqa: E731
    out = cuda_mont.mont_mul(arr(a), arr(b), arr(ns))
    assert out.shape == (L, B) and out.dtype == jnp.uint32
    # operands reach the kernel unbroadcast and unpadded, as uint32
    assert calls == [((L, width[a_cols]), (L, width[b_cols]),
                      (L, width[n_cols]), jnp.uint32, jnp.uint32,
                      jnp.uint32, B)]
    a_b = a * B if len(a) == 1 else a
    b_b = b * B if len(b) == 1 else b
    assert limb.limbs_to_ints(np.asarray(out)) == [
        _mont_ref(x, y, m, L) for x, y, m in zip(a_b, b_b, n_cols_ints)]


@pytest.mark.parametrize("shapes, message", [
    (((4, 8), (4, 6), (4, 1)), "do not broadcast"),
    (((4, 8), (5, 8), (4, 1)), "limb counts differ"),
    (((4, 8), (4, 8), (4,)), "limb arrays"),
])
def test_wrapper_rejects_bad_shapes(shapes, message):
    a, b, n = (jnp.zeros(s, jnp.uint32) for s in shapes)
    with pytest.raises(ValueError, match=message):
        cuda_mont.shape_args(a, b, n)


def test_wrapper_casts_to_uint32():
    a = jnp.ones((3, 4), jnp.int32)
    a2, b2, n2, B = cuda_mont.shape_args(a, a, jnp.ones((3, 1), jnp.int32))
    assert B == 4 and all(x.dtype == jnp.uint32 for x in (a2, b2, n2))


def test_library_name_follows_the_source():
    path = cuda_mont.library_path()
    assert path.startswith(cuda_mont._BUILD_DIR)
    assert path == cuda_mont.library_path()


# -- the reference the kernel is held to ---------------------------------------

@pytest.mark.parametrize("L", [3, 8, 17])
@pytest.mark.parametrize("per_element", [False, True])
def test_jnp_product_equals_the_montgomery_formula(L, per_element):
    """_mont_mul_jnp returns exactly (a*b + M*n)/R: the limbs the CUDA
    kernel must reproduce bit for bit."""
    B = 9
    ns = [_odd_modulus(L) for _ in range(B if per_element else 1)]
    ctx = (mg.MontCtx.for_moduli(ns, L) if per_element
           else mg.MontCtx.for_modulus(ns[0], min_bits=16 * L))
    assert ctx.num_limbs == L
    mods = ns if per_element else ns * B
    xs = [rng.randrange(2 * m) for m in mods]
    ys = [rng.randrange(2 * m) for m in mods]
    got = mg._mont_mul_jnp(jnp.asarray(limb.ints_to_limbs(xs, L)),
                           jnp.asarray(limb.ints_to_limbs(ys, L)), ctx)
    want = [_mont_ref(x, y, m, L) for x, y, m in zip(xs, ys, mods)]
    assert limb.limbs_to_ints(np.asarray(got)) == want
    assert all(w < 2 * m for w, m in zip(want, mods))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [129, 257])
@pytest.mark.parametrize("per_element", [False, True])
def test_cuda_product_matches_jnp(gpu_device, L, per_element):
    B = 4099
    ns = [_odd_modulus(L) for _ in range(B if per_element else 1)]
    ctx = (mg.MontCtx.for_moduli(ns, L) if per_element
           else mg.MontCtx.for_modulus(ns[0], min_bits=16 * L))
    mods = ns if per_element else ns * B
    a = jnp.asarray(limb.ints_to_limbs([rng.randrange(2 * m) for m in mods],
                                       L))
    b = jnp.asarray(limb.ints_to_limbs([rng.randrange(2 * m) for m in mods],
                                       L))
    got = np.asarray(cuda_mont.mont_mul(a, b, ctx.n_limbs))
    want = np.asarray(mg._mont_mul_jnp(a, b, ctx))
    assert np.array_equal(got, want)


# -- the op-count window rule --------------------------------------------------

def _products(w, ebits, sliding):
    if sliding:
        return (1 << (w - 1)) + ebits / (w + 1)
    return (1 << w) - 2 + -(-ebits // w)


@pytest.mark.parametrize("ebits, sliding, window", [
    (16, False, 2), (64, False, 3), (256, False, 4), (2048, False, 6),
    (128, True, 4), (1024, True, 6), (1536, True, 6), (2048, True, 7),
])
def test_window_rule_values(ebits, sliding, window):
    assert sch.window_for(ebits, sliding) == window
    best = min(_products(w, ebits, sliding) for w in range(2, 9))
    assert _products(window, ebits, sliding) == best


def test_window_rule_grows_with_the_exponent():
    for sliding in (False, True):
        ws = [sch.window_for(e, sliding) for e in range(1, 5000, 7)]
        assert ws == sorted(ws) and ws[0] == 2


def test_decrypt_and_mul_windows_follow_the_rule():
    kd = fixed_key_ints(256)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])
    ebits = max((kd["p"] - 1).bit_length(), (kd["q"] - 1).bit_length())
    assert priv.rns_sched_window == sch.window_for(ebits, sliding=True)
    assert len(priv.rsched_p) == ebits + -(-ebits // priv.rns_sched_window)


def test_compile_cache_rule(monkeypatch, tmp_path):
    from pailliercryptolib_python_tpu.utils import compile_cache
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure() == str(tmp_path)
    assert updates == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = compile_cache.configure()
    assert path == f"{compile_cache.CHECKOUT}/.jax_cache"
    assert updates == [("jax_compilation_cache_dir", path)]
