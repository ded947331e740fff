"""The port's counterparts of the TPU experiment scripts in ``tools/``, each
with a hand-written CUDA kernel and its plain PyTorch version:

* ``exp_weight_stream`` (T7): the talker's weight stream with almost no
  compute, beside the full step;
* ``exp_tk_b1_ablate`` (T6): K1's B=1 step split by part;
* ``exp_hbm_peak`` (T3): the card's sustained read rate.

Run one on the card with ``python -m qwen3tts_tpu_torch.tools.<name>``.
"""
