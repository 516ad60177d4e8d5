"""ctypes bindings to the port's native host runtime (port of
``runtime/native.py``; C++ source ``csrc/ccv_runtime.cpp``).

The library is built with g++ at first use into ``build/host_runtime/`` at
the repository root, named by a hash of the source and the flags, as
``kernels/build.py`` names the CUDA libraries: an edited source rebuilds, an
unchanged one is reused. It is never written into or loaded from
``native/``, the JAX package's directory. A failed build raises.

- :class:`RateExecutor` — absolute-deadline periodic scheduler (the
  reference's ros::Rate with honest deadline-miss accounting);
- :class:`SpscRing` — wait-free latest-wins record queue (the reference's
  queue_size=1 topic subscriptions);
- :class:`NativeCsvRecorder` — background-thread CSV writer;
- :func:`native_oracle_step` / :func:`native_oracle_bench_ns` — the C++
  double-precision pipeline oracle, for cross-language parity and measured
  CPU baselines.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ccv_mppi_path_tracker_tpu_torch.models.rate_limited_steering import RATE_MAX, STEER_MAX

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "ccv_runtime.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "host_runtime"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return Path(build_dir) / f"libccv_runtime_{digest.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR):
    """Compile csrc/ccv_runtime.cpp into ``build_dir`` unless an up-to-date
    library is there. Returns (path, seconds); seconds is 0.0 when nothing
    was built."""
    out = library_path(build_dir)
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """Build if needed and load the library (once per process)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()[0]))
        c_d, c_vp, c_i, c_st = ctypes.c_double, ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        dp = ctypes.POINTER(ctypes.c_double)
        lib.ccv_rate_new.restype = c_vp
        lib.ccv_rate_new.argtypes = [c_d]
        lib.ccv_rate_sleep.restype = c_d
        lib.ccv_rate_sleep.argtypes = [c_vp]
        lib.ccv_rate_stats.argtypes = [c_vp, dp]
        lib.ccv_rate_free.argtypes = [c_vp]
        lib.ccv_ring_new.restype = c_vp
        lib.ccv_ring_new.argtypes = [c_st, c_st]
        lib.ccv_ring_push.argtypes = [c_vp, c_vp]
        lib.ccv_ring_pop.restype = c_i
        lib.ccv_ring_pop.argtypes = [c_vp, c_vp]
        lib.ccv_ring_latest.restype = ctypes.c_int64
        lib.ccv_ring_latest.argtypes = [c_vp, c_vp]
        lib.ccv_ring_size.restype = c_st
        lib.ccv_ring_size.argtypes = [c_vp]
        lib.ccv_ring_free.argtypes = [c_vp]
        lib.ccv_csv_open.restype = c_vp
        lib.ccv_csv_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, c_i]
        lib.ccv_csv_row.argtypes = [c_vp, dp, c_i]
        lib.ccv_csv_close.argtypes = [c_vp]
        oracle_args = [c_i, c_i, c_i, c_i, dp, dp, dp, c_i, dp, dp, dp, c_vp]
        lib.ccv_oracle_step.argtypes = oracle_args + [dp, dp]
        lib.ccv_oracle_bench_ns.restype = c_d
        lib.ccv_oracle_bench_ns.argtypes = oracle_args + [c_i]
        _lib = lib
        return lib


class _OracleParams(ctypes.Structure):
    _fields_ = [
        ("control_noise", ctypes.c_double),
        ("lambda_", ctypes.c_double),
        ("v_ref", ctypes.c_double),
        ("resolution", ctypes.c_double),
        ("dt", ctypes.c_double),
        ("path_weight", ctypes.c_double),
        ("v_weight", ctypes.c_double),
        ("zmp_weight", ctypes.c_double),
        ("roll_v_weight", ctypes.c_double),
        ("back_weight", ctypes.c_double),
        ("yaw_weight", ctypes.c_double),
        ("mass", ctypes.c_double),
        ("base2com", ctypes.c_double),
        ("inertia", ctypes.c_double * 3),
        ("gravity_z", ctypes.c_double),
        ("steer_off", ctypes.c_int),
        ("steer_max", ctypes.c_double),
        ("rate_max", ctypes.c_double),
    ]


MODEL_IDS = {
    "unicycle": 0,
    "steering_unicycle": 1,
    "full_body": 2,
    "rate_limited_steering": 3,
}


class RateExecutor:
    """Fixed-rate loop: ``for _ in range(n): dt = rate.sleep()``."""

    def __init__(self, hz: float):
        self._lib = load_library()
        self._h = self._lib.ccv_rate_new(hz)

    def sleep(self) -> float:
        """Sleep to the next absolute deadline; returns the measured dt
        since the previous call. A deadline already passed counts as a miss
        and re-anchors the schedule."""
        return self._lib.ccv_rate_sleep(self._h)

    def stats(self) -> dict:
        out = (ctypes.c_double * 4)()
        self._lib.ccv_rate_stats(self._h, out)
        return {
            "cycles": int(out[0]),
            "deadline_misses": int(out[1]),
            "mean_dt": out[2],
            "max_abs_jitter": out[3],
        }

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ccv_rate_free(self._h)
            self._h = None


class SpscRing:
    """Latest-wins ring of float64 records of fixed length.

    Strictly single-producer/single-consumer. When the ring is full the
    producer drops the oldest unread record (queue_size=1 topic semantics);
    a consumer popping concurrently with an overwrite of the same slot can
    observe a dropped record: size the capacity above the expected burst if
    every record matters, or use :meth:`latest` (the control-loop pattern),
    which only ever reads the newest slot."""

    def __init__(self, capacity: int, record_len: int):
        self._lib = load_library()
        self.record_len = record_len
        self._h = self._lib.ccv_ring_new(capacity, record_len * 8)

    def push(self, record) -> None:
        rec = np.ascontiguousarray(record, np.float64)
        if rec.size != self.record_len:
            raise ValueError(f"record of {rec.size} values, the ring holds {self.record_len}")
        self._lib.ccv_ring_push(self._h, rec.ctypes.data_as(ctypes.c_void_p))

    def pop(self):
        out = np.empty(self.record_len, np.float64)
        if self._lib.ccv_ring_pop(self._h, out.ctypes.data_as(ctypes.c_void_p)):
            return out
        return None

    def latest(self):
        """Returns (seq, record) of the newest write, or (None, None)."""
        out = np.empty(self.record_len, np.float64)
        seq = self._lib.ccv_ring_latest(self._h, out.ctypes.data_as(ctypes.c_void_p))
        if seq < 0:
            return None, None
        return int(seq), out

    def __len__(self):
        return int(self._lib.ccv_ring_size(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ccv_ring_free(self._h)
            self._h = None


class NativeCsvRecorder:
    """CSV writer whose fwrite happens on a native background thread; a NaN
    is written as an empty cell."""

    def __init__(self, path: str, columns):
        self._lib = load_library()
        self.ncols = len(columns)
        self._h = self._lib.ccv_csv_open(str(path).encode(), ",".join(columns).encode(),
                                         self.ncols)
        if not self._h:
            raise OSError(f"cannot open {path}")

    def row(self, values) -> None:
        vals = np.ascontiguousarray(values, np.float64)
        self._lib.ccv_csv_row(self._h, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                              vals.size)

    def close(self) -> None:
        """Flush every queued row, join the writer thread, close the file."""
        if self._h:
            self._lib.ccv_csv_close(self._h)
            self._h = None


def _np(x):
    """A float64 array of a number, array or tensor (a device tensor is
    read back)."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)


def _pack_params(resolution, dt, control_noise, lam, v_ref, cp=None, model_params=None,
                 steer_off=False):
    p = _OracleParams()
    p.control_noise = float(control_noise)
    p.lambda_ = float(lam)
    p.v_ref = float(v_ref)
    p.resolution = float(resolution)
    p.dt = float(dt)
    weights = dict(path_weight=1.0, v_weight=1.0, zmp_weight=1.0, roll_v_weight=1.0,
                   back_weight=1.0, yaw_weight=1.0)
    if cp is not None:
        weights = {k: float(_np(getattr(cp, k))) for k in weights}
    for k, v in weights.items():
        setattr(p, k, v)
    if model_params is not None:
        p.mass = float(_np(model_params.mass))
        p.base2com = float(_np(model_params.base2com))
        for i, v in enumerate(_np(model_params.inertia)):
            p.inertia[i] = float(v)
        p.gravity_z = float(_np(model_params.gravity_z))
    else:
        p.mass, p.base2com, p.gravity_z = 60.0, 0.8075 / 2, -9.8
    p.steer_off = int(steer_off)
    p.steer_max = STEER_MAX
    p.rate_max = RATE_MAX
    return p


def _oracle_args(model, u_prev, state, path_xy, resolution, dt, noise, control_noise, lam,
                 u_min, u_max, v_ref, cp, model_params, steer_off):
    """The leading arguments of ccv_oracle_step / ccv_oracle_bench_ns, and
    the arrays they point into (kept alive by the caller)."""
    arrays = [np.ascontiguousarray(_np(a)) for a in (state, u_prev, path_xy, noise, u_min,
                                                     u_max)]
    state, u_prev, path_xy, noise, u_min, u_max = arrays
    tm1, k, u_dim = noise.shape
    params = _pack_params(resolution, dt, control_noise, lam, v_ref, cp, model_params,
                          steer_off)
    dp = ctypes.POINTER(ctypes.c_double)
    args = [MODEL_IDS[model], tm1 + 1, k, u_dim, state.ctypes.data_as(dp),
            u_prev.ctypes.data_as(dp), path_xy.ctypes.data_as(dp), len(path_xy),
            noise.ctypes.data_as(dp), u_min.ctypes.data_as(dp), u_max.ctypes.data_as(dp),
            ctypes.byref(params)]
    return args, (arrays, params)


def native_oracle_step(
    model, u_prev, state, path_xy, resolution, dt, noise, control_noise, lam,
    u_min, u_max, v_ref, cp=None, model_params=None, steer_off=False,
):
    """C++ oracle control update on injected noise (T-1, K, U). Returns
    dict(u_opt (T-1, U), costs (K,)). The weights come from ``cp`` (all 1.0
    without it), the full-body constants from ``model_params``; arrays and
    tensors (read back from the card) are both taken."""
    lib = load_library()
    args, keep = _oracle_args(model, u_prev, state, path_xy, resolution, dt, noise,
                              control_noise, lam, u_min, u_max, v_ref, cp, model_params,
                              steer_off)
    tm1, k, u_dim = keep[0][3].shape
    u_opt = np.zeros((tm1, u_dim))
    costs = np.zeros(k)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ccv_oracle_step(*args, u_opt.ctypes.data_as(dp), costs.ctypes.data_as(dp))
    return {"u_opt": u_opt, "costs": costs}


def native_oracle_bench_ns(
    model, u_prev, state, path_xy, resolution, dt, noise, control_noise, lam,
    u_min, u_max, v_ref, cp=None, model_params=None, steer_off=False, iters=10,
):
    """Measured serial-CPU ns per full control update (the honest baseline)."""
    lib = load_library()
    args, _keep = _oracle_args(model, u_prev, state, path_xy, resolution, dt, noise,
                               control_noise, lam, u_min, u_max, v_ref, cp, model_params,
                               steer_off)
    return lib.ccv_oracle_bench_ns(*args, iters)
