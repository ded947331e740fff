"""Build and load the hand-written CUDA kernels (qwen3tts_tpu_torch/csrc).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes`` (no PyTorch headers, so the build takes
seconds). Each ``.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more links them. The build happens at first use, from the
sources in the checkout only, into ``build/qwen3tts_tpu_torch/`` at the
repository root; the library name carries a hash of the sources, so an
edited source rebuilds.

Every C entry returns ``cudaGetLastError()`` after its launches; ``check``
raises on a non-zero code. Nothing here falls back to anything.

The kernels' limits (``LIMITS``: the most rows, the head size, the partial
sum rows, the dyn_int8 amax slots) are read from csrc/common.cuh's
``constexpr`` lines, not copied, so the wrappers' checks cannot drift from
the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def header_ints(path: Path) -> dict[str, int]:
    """The integer constants of a header: ``constexpr int NAME = value;``."""
    pat = re.compile(r"^constexpr (?:int|uint32_t) (\w+) = (\d+);", re.M)
    return {name: int(value) for name, value in pat.findall(path.read_text())}


LIMITS = header_ints(CSRC / "common.cuh")  # also the persistent B = 1 kernels' PF_* constants
TALKER_FRAME_LIMITS = header_ints(CSRC / "talker_frame.cu")  # K1's persistent B = 1 step (TF_*)
MAX_BATCH = LIMITS["MAX_BATCH"]  # rows of one K1 / K2 call
_GEMM = header_ints(CSRC / "quant_gemm.cu")
# the most rows quant_gemm's stream form takes in its automatic choice, by x type
GEMM_CROSS = {torch.bfloat16: _GEMM["QG_CROSS_BF16"], torch.float32: _GEMM["QG_CROSS_F32"]}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qwen3tts_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U = ctypes.c_uint32
LL = ctypes.c_longlong

# argument types of the C entries, in order (csrc/talker_step.cu, talker_frame.cu, cp_loop.cu,
# quant_matmul.cu, quant_gemm.cu, decode_attention.cu, weight_stream.cu, talker_ablate.cu,
# hbm_read.cu, attn_forms.cu, int4_repack.cu, kv_append.cu, cpk_probes.cu)
_ARGTYPES = {
    "qt_quant_gemv": [I, I, I, I, I, P, P, P, P, P, I, P],  # O I bits group x_bf16 x w s b y rpw stream
    "qt_quant_gemm": [
        I, I, I, I, I, I,  # M O I bits group x_bf16
        P, P, P, P, P, I, I, I, P,  # x w s b y form row_tiles slices stream
    ],
    "qt_quant_gemm_tiles": [I, I, I, I],  # M I bits group
    "qt_quant_gemm_form": [I, I, I, I, I, I],  # M O I bits group x_bf16
    "qt_decode_attention": [
        I, I, I, I, I, F, I,  # NQ NKV D T pos scale NC
        P, P, P, P, P, P, P, P,  # q k v part_ml part_acc counters out stream
    ],
    "qt_decode_attention_cut": [
        I, I, I, I, I, I, F, I,  # cut NQ NKV D T pos scale NC
        P, P, P, P, P, P, P, P,  # q k v part_ml part_acc counters out stream
    ],
    "qt_talker_step": [
        I, I, I, I, I, I, I, I, I, I, P,  # L H NQ NKV D I V T B pos offs
        I, I, I, I, F, F,  # kv_quant w_bf16 head_bf16 dyn eps scale
        P,  # x
        P, P, P, P, P, P, P, P,  # qkv_w qkv_s o_w o_s gu_w gu_s d_w d_s
        P, P, P, P, P,  # iln pln qn kn fnorm
        P, P, P, P,  # k_cache v_cache k_scale v_scale
        P, P, I,  # cos sin rope_stride
        P, P, P, P,  # head_w head_s supp seen
        F, I, F, I, F, I, I, U, U,  # rep greedy inv_t top_k top_p_thr ref_exact eos_id seed0 seed1
        P,  # samp_rows
        P, P, P, P, P, P,  # hres xn attn gated ws amax
        P, P, P,  # code_out logits_out stream
    ],
    "qt_talker_frame": [
        I, I, I, I, I, I, I, I, I, P,  # L H NQ NKV D I V T pos offs
        I, I, I, I, F, F,  # kv_quant w_bf16 head_bf16 dyn eps scale
        P,  # x
        P, P, P, P, P, P, P, P,  # qkv_w qkv_s o_w o_s gu_w gu_s d_w d_s
        P, P, P, P, P,  # iln pln qn kn fnorm
        P, P, P, P,  # k_cache v_cache k_scale v_scale
        P, P,  # cos sin
        P, P, P, P,  # head_w head_s supp seen
        F, I, F, I, F, I, I, U, U,  # rep greedy inv_t top_k top_p_thr ref_exact eos_id seed0 seed1
        P, P, I, P,  # ws att cmax xn
        P, P, P, P, I, LL, I,  # code_out logits_out ctl err_host blocks budget_ns cut
        I, P,  # part h_out
        P,  # stream
    ],
    "qt_cp_loop": [
        I, I, I, I, I, I, I, I, I, I,  # L H NQ NKV D I V NCB B TH
        I, I, I, F, F,  # w_bf16 head_bf16 dyn eps scale
        P,  # x0
        P, P, P, P, P, P, P, P,  # q_w q_s k_w k_s v_w v_s o_w o_s
        P, P, P, P, P, P,  # g_w g_s u_w u_s d_w d_s
        P, P, P, P, P,  # iln pln qn kn fnorm
        P, P, P, P, P,  # lm_w lm_s emb proj_w proj_b
        P, P, P, P,  # cos_tab sin_tab k_cache v_cache
        I, F, I, F, I, U, U,  # greedy inv_t top_k top_p_thr ref_exact seed0 seed1
        P, P,  # samp_rows force_codes
        P, P, P, P, P, P, P,  # hres xn attn gated ws xbuf amax
        P, P, P,  # codes_out esum logits_out
        P, P, I, LL, I,  # ctl err_host blocks budget_ns cut
        P,  # stream
    ],
    "qt_cp_gemv_splits": [I, I, I],  # B I O
    "qt_cp_gemv_rows": [I, I, I],  # B I O
    "qt_cp_gemv": [I, I, I, I, I, I, P, P, P, P, P],  # tc w_bf16 dyn B I O w x amax part stream
    "qt_weight_stream": [
        I, P, P, P, P,  # n w[] layer_bytes[] esz[] tile[] (host arrays)
        I, I, I, I,  # L form B H
        P, P, P, P, P,  # x h sums tiles stream
    ],
    "qt_talker_ablate_dma": [
        I, I, I, I, I, I, I, I, I,  # L H NQ NKV D I T B pos
        P, P, P, P, P,  # x qkv_w o_w gu_w d_w
        P, P, P, P, P, P,  # k_cache v_cache hres sums tiles stream
    ],
    "qt_hbm_colsum": [P, LL, LL, I, I, I, P, P],  # x total_rows row0 rows blk_rows group out stream
    "qt_attn_form": [I, I, I, I, I, P, P, P, P, P, P],  # k_transposed Bt M W n q k v part out stream
    "qt_int4_mxu": [I, I, I, P, P, P, P, P, P],  # O I NG x frag (mxu_repack order) scales biases y stream
    "qt_int4_plane": [I, I, I, P, P, P, P, P, P],  # O I NG x lo hi scales y stream
    "qt_kv_append": [I, I, I, I, I, P, P, P, P, P, P],  # L B H T D k_cache v_cache k_new v_new offsets stream
    "qt_cpk_p1_reshape": [I, I, P, P, P],  # rows cols x out stream
    "qt_cpk_p2_int8_dot": [I, I, P, P, P, P],  # K N x w out stream
    "qt_cpk_p3_dynrow": [I, I, P, P, P],  # p cols x out stream
    "qt_cpk_p3a_dynrow_f32": [I, I, P, P, P],
    "qt_cpk_p3b_dynrow_bf16": [I, I, P, P, P],
    "qt_cpk_p3c_where_row": [I, I, P, P, P],
    "qt_cpk_p4_argmax_row": [I, I, I, P, P, P, P, P],  # N V E z emb codes row stream
    "qt_cpk_p4a_argmax": [I, P, P, P],  # N z codes stream
    "qt_cpk_p4b_argmax_row": [I, I, I, P, P, P, P],  # N V E z emb row stream
    "qt_cpk_p4c_argmax_smem_row": [I, I, I, P, P, P, P],
    "qt_cpk_p5_counter_bits": [U, I, P, P],  # seed n out stream
    "qt_cpk_p6_convert_dot": [I, I, P, P, P, P],  # K N x w out stream
}

build_seconds: float | None = None  # wall time of this process's build, if it built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global build_seconds
    srcs = _sources()
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libqt_kernels_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{digest}.{os.getpid()}"
        t0 = time.time()
        objs, procs = [], []
        for src in (p for p in srcs if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = [(p.communicate()[0], p.returncode) for p in procs]
        failed = [f"{o.name}: {out}" for o, (out, rc) in zip(objs, outs) if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        for obj in objs:
            obj.unlink()
        os.replace(tmp, lib_path)
        build_seconds = time.time() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.qt_launches.argtypes = []
    lib.qt_launches.restype = ctypes.c_ulonglong
    return lib


def launches() -> int:
    """Operations (kernel launches, memsets) K1 and K2 have enqueued in
    this process, counted on the host by the library itself
    (``launch_count`` in csrc/common.cuh): exact, where a profiler window
    can drop device records."""
    return int(library().qt_launches())


def workspace_rows(batch: int) -> int:
    """Rows of O floats the GEMV partial sums take: GEMV_MAX_SPLIT at one
    row, TC_MAX_PARTS at more (the tensor-core form every batched GEMV
    runs)."""
    return LIMITS["GEMV_MAX_SPLIT"] if batch == 1 else LIMITS["TC_MAX_PARTS"]


def amax_slots(batch: int, device) -> torch.Tensor:
    """The per-row activation amax slots of one dyn_int8 call (AMAX_SLOTS x
    batch floats); the kernels set them before any read (common.cuh)."""
    return torch.empty(LIMITS["AMAX_SLOTS"] * batch, dtype=torch.float32, device=device)


class CoResidencyError(RuntimeError):
    """A persistent B = 1 kernel's grid cannot be resident on the card at once."""


class BarrierTimeout(RuntimeError):
    """A grid barrier of a persistent B = 1 kernel waited past its budget."""


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def ptr(t: torch.Tensor | None):
    """Data pointer of a contiguous CUDA tensor (None -> NULL)."""
    if t is None:
        return None
    if t.device.type != "cuda":
        raise ValueError(f"kernel operands must be CUDA tensors, got one on {t.device}")
    if not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    return t.data_ptr()


def device_key(device) -> torch.device:
    """A CUDA device with its index: ``cuda`` (the current device; device 0
    where no card is present, as nothing launches then) and ``cuda:0`` name
    one device where it is current, so the per-device caches and flags of
    ops/ key by this. Other devices are returned as they are."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)


@contextlib.contextmanager
def on_device(device):
    """Enqueue on ``device``: make it the thread's current device (the C
    entries launch on the runtime's current device) and yield the handle of
    its current stream. A launch whose operands lie on ``cuda:1`` while the
    thread's current device is 0 would go to the wrong device."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream
