"""The port's counterparts of the TPU experiment scripts in ``tools/``, each
with a hand-written CUDA kernel and its plain PyTorch version:

* ``exp_weight_stream`` (T7): the talker's weight stream with almost no
  compute, beside the full step;
* ``exp_tk_b1_ablate`` (T6): K1's B=1 step split by part;
* ``exp_hbm_peak`` (T3): the card's sustained read rate;
* ``exp_attn_forms`` (T1): batched GQA scores . values in four forms, on
  the tensor cores;
* ``exp_int4_repack`` (T4): two alternatives to K4's packed-int4 matvec
  (dequantize then tensor cores; nibble planes on the CUDA cores) beside K4;
* ``exp_kv_append`` (T5): the batched in-place KV row append, beside the
  plain per-sequence copies and ``index_put_``;
* ``exp_cpk`` (T2): twelve unit probes of the code predictor kernel's
  building blocks.

Run one on the card with ``python -m qwen3tts_tpu_torch.tools.<name>``.

Beside them, the counterparts of the JAX package's checkpoint tools:

* ``parity_harness``: the greedy-parity dump (vocoder stage statistics on
  the golden codes, the greedy tokens, the waveform) and ``--compare``;
* ``inspect_ckpt``: a checkpoint's key listing against the loader's;
* ``ckpt_layout``: the raw checkpoint layout both build on, and the
  synthetic checkpoint both packages load.
"""
