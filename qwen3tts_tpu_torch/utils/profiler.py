"""Per-neuron FFN activation profiler for MLP-pruning analysis
(port of qwen3tts_tpu/utils/profiler.py).

Records the max |silu(gate(x)) * up(x)| per (layer, neuron) over
generation runs, prints a threshold table and exports JSON. As in the JAX
package, the decode itself is not hooked: after an utterance the model
replays the generated sequence through one teacher-forced forward
(``models/talker.py::activation_stats``, called by
``Qwen3TTSModel._profile_replay``), whose activations are the decode's,
since its inputs and causal masking are. The decode keeps running on K1
and K2; only the replay is plain PyTorch.
"""

from __future__ import annotations

import json

import numpy as np
import torch


class ActivationProfiler:
    def __init__(self):
        self.is_enabled = False
        self.num_layers = 0
        self.intermediate_size = 0
        self.run_count = 0
        self._max: np.ndarray | None = None  # [L, inter] global max
        self._sum: np.ndarray | None = None  # [L, inter] sum of per-run maxes
        self._current: np.ndarray | None = None  # per-run max accumulator

    def enable(self, num_layers: int, intermediate_size: int) -> None:
        self.is_enabled = True
        self.num_layers = num_layers
        self.intermediate_size = intermediate_size
        self.run_count = 0
        self._max = np.zeros((num_layers, intermediate_size), np.float32)
        self._sum = np.zeros((num_layers, intermediate_size), np.float32)
        self._current = None

    def disable(self) -> None:
        self.is_enabled = False

    def record(self, act_max) -> None:
        """Accumulate a [L, intermediate] per-neuron max (a tensor on any
        device, or an array) from one forward."""
        if not self.is_enabled:
            return
        if isinstance(act_max, torch.Tensor):
            act_max = act_max.detach().float().cpu().numpy()
        act = np.asarray(act_max, np.float32)
        if self._current is None:
            self._current = act.copy()
        else:
            np.maximum(self._current, act, out=self._current)

    def flush_run(self) -> None:
        """Fold the current run into the global stats (once per generation)."""
        if not self.is_enabled or self._current is None:
            return
        np.maximum(self._max, self._current, out=self._max)
        self._sum += self._current
        self.run_count += 1
        self._current = None

    def print_summary(self, thresholds=(0.01, 0.05, 0.1, 0.5, 1.0)) -> None:
        print("=" * 70)
        print(f"ACTIVATION PROFILING RESULTS ({self.run_count} runs)")
        print("=" * 70)
        header = " Layer |" + "".join(f" <{t:5.2f}" for t in thresholds) + " | Active |  Dead%"
        print(header)
        print("-" * 70)
        total = np.zeros(len(thresholds), int)
        for layer in range(self.num_layers):
            counts = [(self._max[layer] < t).sum() for t in thresholds]
            active = self.intermediate_size - counts[-1]
            dead_pct = counts[-1] / self.intermediate_size * 100
            print(
                f"  L{layer:3d}  |"
                + "".join(f" {c:5d}" for c in counts)
                + f" | {active:6d} | {dead_pct:5.1f}%"
            )
            total += counts
        print("-" * 70)
        avg_dead = total[-1] / max(self.num_layers * self.intermediate_size, 1) * 100
        print(
            "  AVG  |"
            + "".join(f" {c // max(self.num_layers, 1):5d}" for c in total)
            + f" |        | {avg_dead:5.1f}%"
        )

    def save_json(self, path: str) -> None:
        mean = self._sum / max(self.run_count, 1)
        out = {
            "num_layers": self.num_layers,
            "intermediate_size": self.intermediate_size,
            "run_count": self.run_count,
            "layers": [
                {
                    "layer": layer,
                    "max_activations": self._max[layer].tolist(),
                    "mean_activations": mean[layer].tolist(),
                }
                for layer in range(self.num_layers)
            ],
        }
        with open(path, "w") as f:
            json.dump(out, f, sort_keys=True)
        print(f"Activation profile saved to: {path}")
