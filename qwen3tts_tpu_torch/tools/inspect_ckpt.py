"""Diff a checkpoint's safetensors key listing against what the port's
loader expects (port of tools/inspect_ckpt.py): the first diagnostic for
real weights.

For the checkpoint's OWN config it builds the complete expected name ->
shape listing of the main checkpoint and of ``speech_tokenizer/``
(``ckpt_layout``'s weight functions with ``shape_only``: no tensor is allocated)
and diffs it against the safetensors headers, which are parsed alone: no
tensor data is read. A quantized config (MLX affine) expects each packed
linear weight as ``.weight`` [O, I * bits / 32] with ``.scales`` and
``.biases`` [O, I / group].

    python -m qwen3tts_tpu_torch.tools.inspect_ckpt <model_dir>         # report
    python -m qwen3tts_tpu_torch.tools.inspect_ckpt <model_dir> --keys  # and both listings

Exit 0: the key sets match (a shape mismatch is a warning). Exit 1: missing
or unexpected keys. Exit 2: no directory given.
"""

from __future__ import annotations

import json
import os
import struct
import sys

import numpy as np

from . import ckpt_layout as layout


def read_safetensors_header(path: str) -> dict[str, tuple[str, tuple[int, ...]]]:
    """name -> (dtype, shape) from the file header; tensor data untouched."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return {
        k: (v["dtype"], tuple(v["shape"]))
        for k, v in header.items()
        if k != "__metadata__"
    }


def actual_listing(model_dir: str) -> dict[str, tuple[str, tuple[int, ...]]]:
    out = {}
    for f in sorted(os.listdir(model_dir)):
        if f.endswith(".safetensors"):
            out.update(read_safetensors_header(os.path.join(model_dir, f)))
    return out


def expected_listing(model_dir: str) -> dict[str, tuple[int, ...]]:
    """Expected main-checkpoint names and shapes for this config."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    w = layout.build_main_weights(cfg, mat=layout.shape_only)
    if cfg.get("quantization"):
        q = cfg["quantization"]
        w = quantized_names(w, bits=q.get("bits", 4), group=q.get("group_size", 32))
    return {k: tuple(v.shape) for k, v in w.items()}


def quantized_names(w: dict, bits: int, group: int) -> dict:
    """The names and shapes of an MLX-quantized checkpoint, without
    quantizing."""
    out = {}
    for k, v in w.items():
        if layout.is_quantized_linear(k, v.shape, group):
            o, i = v.shape
            out[k] = np.broadcast_to(np.uint32(0), (o, i // (32 // bits)))
            out[k + ".scales"] = np.broadcast_to(np.float32(0), (o, i // group))
            out[k + ".biases"] = np.broadcast_to(np.float32(0), (o, i // group))
        else:
            out[k] = v
    return out


def expected_st_listing(st_dir: str) -> dict[str, tuple[int, ...]]:
    with open(os.path.join(st_dir, "config.json")) as f:
        st_cfg = json.load(f)
    w = layout.build_speech_tokenizer_weights(st_cfg, mat=layout.shape_only)
    return {k: tuple(v.shape) for k, v in w.items()}


def diff(tag: str, expected: dict, actual: dict, show_keys: bool) -> int:
    exp_keys, act_keys = set(expected), set(actual)
    missing = sorted(exp_keys - act_keys)
    unexpected = sorted(act_keys - exp_keys)
    mismatched = sorted(
        k for k in exp_keys & act_keys if tuple(expected[k]) != tuple(actual[k][1])
    )
    print(f"== {tag}: {len(act_keys)} on disk, {len(exp_keys)} expected")
    for k in missing:
        print(f"  MISSING    {k}  (loader expects shape {expected[k]})")
    for k in unexpected:
        print(f"  UNEXPECTED {k}  {actual[k][1]} {actual[k][0]}")
    for k in mismatched:
        print(f"  SHAPE      {k}: disk {actual[k][1]} vs expected {expected[k]}")
    if not (missing or unexpected or mismatched):
        print("  OK: key sets and shapes match")
    if show_keys:
        for k in sorted(exp_keys | act_keys):
            mark = " " if k in exp_keys and k in act_keys else ("-" if k in exp_keys else "+")
            print(f"  {mark} {k}")
    return len(missing) + len(unexpected)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    show_keys = "--keys" in argv
    args = [a for a in argv if not a.startswith("--")]
    if not args:
        print(__doc__)
        return 2
    model_dir = args[0]
    bad = diff(
        "main checkpoint", expected_listing(model_dir), actual_listing(model_dir), show_keys,
    )
    st_dir = os.path.join(model_dir, "speech_tokenizer")
    if os.path.isdir(st_dir):
        bad += diff(
            "speech_tokenizer", expected_st_listing(st_dir), actual_listing(st_dir), show_keys,
        )
    else:
        print("== speech_tokenizer/: absent (vocoder/encoder will not load)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
