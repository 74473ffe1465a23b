"""User-plugin likelihood: load a log-density from external code.

JAX equivalent of the reference DLL likelihood
(reference: src/likelihoods/LikelihoodDLL.cpp:34-116, example at
examples/dll_likelihood/code.cpp), which dlopens a user shared library
exporting ``initialize_likelihood`` + ``evaluate_log_probability``.

Two plugin flavors:

- **Python module**: a ``.py`` file exporting
  either ``make_log_prob(variable_names) -> jittable fn`` or a plain
  ``evaluate_log_probability(values) -> float``. The former stays on
  device (jit/vmap-able); the latter is wrapped in
  ``jax.pure_callback`` and runs on the host.
- **C shared library**: a ``.so`` exporting the reference's exact C ABI
  ``bool evaluate_log_probability(ptrdiff_t n, const double* values,
  const char** names, double* log_p)`` (and optional
  ``bool initialize_likelihood(size_t n, const char* const* names)``),
  loaded with ctypes and bridged through ``jax.pure_callback``. Host
  callbacks serialize device->host per evaluation — fine for cheap user
  code, and the only way to honor an opaque native plugin.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
from typing import Callable, List

import jax
import jax.numpy as jnp
import numpy as np


def _load_python_plugin(path: str, variable_names: List[str]) -> Callable:
    spec = importlib.util.spec_from_file_location("bcm3_user_likelihood", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    if hasattr(mod, "initialize_likelihood"):
        if not mod.initialize_likelihood(len(variable_names), variable_names):
            raise RuntimeError("Plugin initialize_likelihood returned False")

    if hasattr(mod, "make_log_prob"):
        return mod.make_log_prob(variable_names)
    if hasattr(mod, "evaluate_log_probability"):
        host_fn = mod.evaluate_log_probability

        def log_prob(values):
            def cb(v):
                return np.asarray(host_fn(np.asarray(v)), dtype=np.float64)

            out = jax.pure_callback(
                cb, jax.ShapeDtypeStruct((), np.float64), values, vmap_method="sequential"
            )
            return out.astype(values.dtype)

        return log_prob
    raise ValueError(
        f"Python plugin {path} must export make_log_prob or "
        "evaluate_log_probability"
    )


def _load_c_plugin(path: str, variable_names: List[str]) -> Callable:
    lib = ctypes.CDLL(path)
    n = len(variable_names)
    name_array = (ctypes.c_char_p * n)(
        *[name.encode() for name in variable_names]
    )

    init = getattr(lib, "initialize_likelihood", None)
    if init is not None:
        init.restype = ctypes.c_bool
        init.argtypes = [ctypes.c_size_t, ctypes.POINTER(ctypes.c_char_p)]
        if not init(n, name_array):
            raise RuntimeError("Plugin initialize_likelihood returned false")

    eval_fn = lib.evaluate_log_probability
    eval_fn.restype = ctypes.c_bool
    eval_fn.argtypes = [
        ctypes.c_ssize_t,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_double),
    ]

    def host_eval(values: np.ndarray) -> np.ndarray:
        v = np.ascontiguousarray(values, dtype=np.float64)
        out = ctypes.c_double(np.nan)
        ok = eval_fn(
            n,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            name_array,
            ctypes.byref(out),
        )
        # a false return / NaN means evaluation failure -> -inf (reject),
        # the framework-wide soft-fail convention
        # (reference: LikelihoodDLL.cpp:103-116 treats it as a hard error;
        # rejection is the safer equivalent under batched evaluation)
        if not ok or np.isnan(out.value):
            return np.float64(-np.inf)
        return np.float64(out.value)

    def log_prob(values):
        out = jax.pure_callback(
            host_eval,
            jax.ShapeDtypeStruct((), np.float64),
            values,
            vmap_method="sequential",
        )
        return out.astype(values.dtype)

    return log_prob


def load_plugin_log_prob(
    filename_base: str, variable_names: List[str], base_dir: str = "."
) -> Callable:
    """Resolve and load a plugin likelihood.

    ``filename_base`` follows the reference convention (no extension,
    ``.so`` appended; reference: LikelihoodDLL.cpp:68-72). A ``.py`` file
    of the same base name is preferred when present.
    """
    candidates = [
        filename_base,
        filename_base + ".py",
        filename_base + ".so",
        os.path.join(base_dir, filename_base),
        os.path.join(base_dir, filename_base + ".py"),
        os.path.join(base_dir, filename_base + ".so"),
        os.path.join(base_dir, "build", filename_base + ".so"),
    ]
    for cand in candidates:
        if os.path.isfile(cand):
            if cand.endswith(".py"):
                return _load_python_plugin(cand, variable_names)
            return _load_c_plugin(cand, variable_names)
    raise FileNotFoundError(
        f"Cannot find plugin likelihood '{filename_base}' "
        f"(tried {candidates})"
    )
