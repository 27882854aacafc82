#!/usr/bin/env python3
"""Generate docs/API.md — the framework's API reference.

The reference carries a sphinx docs build option
(/root/reference/CMakeLists.txt:39-43, IPCL_PYTHON_DOCS); this image has
no sphinx, so the equivalent subsystem is a self-contained generator:
it introspects the public surface (the same classes the reference
documents) and emits one markdown file from the live docstrings and
signatures.  Regenerate after API changes:

    python tools/gen_api_docs.py          # writes docs/API.md
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# force CPU: doc generation must never reserve a GPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
try:
    import jax
    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

# (module, [public names]; None = module's __all__-ish public classes)
SURFACE = [
    ("pailliercryptolib_python_tpu", [
        "PaillierKeypair", "PaillierPublicKey", "PaillierPrivateKey",
        "PaillierEncryptedNumber", "BNUtils",
    ]),
    ("pailliercryptolib_python_tpu.fixedpoint", [
        "FixedPointNumber", "FixedPointEndec", "encode_vector",
        "decode_vector", "decode_limbs_vector",
    ]),
    ("pailliercryptolib_python_tpu.bindings.containers", [
        "ipclKeypair", "ipclPublicKey", "ipclPrivateKey", "ipclPlainText",
        "ipclCipherText", "BigNumber",
    ]),
    ("pailliercryptolib_python_tpu.utils.context", [
        "context", "hybridControl", "hybridMode",
    ]),
    ("pailliercryptolib_python_tpu.utils.config", [
        "Config", "get_config", "set_config",
    ]),
    ("pailliercryptolib_python_tpu.models.paillier", [
        "generate_key_ints", "generate_prime", "PublicContext",
        "PrivateContext",
    ]),
    ("pailliercryptolib_python_tpu.parallel.mesh", [
        "make_mesh", "batch_sharding", "shard_batch", "replicate",
    ]),
    ("pailliercryptolib_python_tpu.parallel.collective", [
        "sharded_he_sum", "sharded_elementwise", "federated_aggregate",
    ]),
    ("pailliercryptolib_python_tpu.parallel.sharded_ops", [
        "sharded_decrypt", "sharded_mul_pt",
    ]),
    ("pailliercryptolib_python_tpu.parallel.distributed", None),
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else "*(no docstring)*"


def _emit_callable(out, name, obj, depth):
    head = "#" * depth
    kind = "class" if inspect.isclass(obj) else "def"
    out.append(f"{head} `{kind} {name}{_sig(obj) if kind == 'def' else ''}`\n")
    out.append(_doc(obj) + "\n")
    if inspect.isclass(obj):
        members = []
        for mname, m in inspect.getmembers(obj):
            if mname.startswith("_") and mname not in (
                    "__add__", "__mul__", "__matmul__", "__getitem__"):
                continue
            if inspect.isfunction(m) or inspect.ismethod(m) \
                    or isinstance(inspect.getattr_static(obj, mname),
                                  (staticmethod, classmethod, property)):
                members.append((mname, m))
        for mname, m in members:
            if isinstance(inspect.getattr_static(obj, mname), property):
                out.append(f"- **`{mname}`** (property) — "
                           f"{(_doc(m).splitlines() or [''])[0]}")
            elif callable(m):
                out.append(f"- **`{mname}{_sig(m)}`** — "
                           f"{(_doc(m).splitlines() or [''])[0]}")
        if inspect.isclass(obj) and issubclass(obj, object) \
                and hasattr(obj, "__members__"):   # enum
            out.append("- members: " + ", ".join(
                f"`{n}`" for n in obj.__members__))
        out.append("")


def main():
    out = [
        "# API reference — pailliercryptolib_python_tpu",
        "",
        "Generated by `tools/gen_api_docs.py` from live docstrings "
        "(the sphinx-docs analog of the reference's IPCL_PYTHON_DOCS "
        "option). Do not edit by hand.",
        "",
        "The `ipcl_python` package is a drop-in alias: "
        "`from ipcl_python import PaillierKeypair` resolves to the same "
        "objects documented here.",
        "",
    ]
    for modname, names in SURFACE:
        mod = importlib.import_module(modname)
        out.append(f"\n## module `{modname}`\n")
        first = (inspect.getdoc(mod) or "").split("\n\n")[0]
        out.append(first + "\n")
        if names is None:
            names = [n for n, o in inspect.getmembers(mod)
                     if not n.startswith("_")
                     and getattr(o, "__module__", None) == modname]
        for name in names:
            obj = getattr(mod, name)
            if inspect.isclass(obj) or callable(obj):
                _emit_callable(out, name, obj, 3)
            else:
                out.append(f"### `{name}`\n\n{_doc(obj)}\n")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "API.md")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {path} ({len(out)} blocks)")


if __name__ == "__main__":
    main()
