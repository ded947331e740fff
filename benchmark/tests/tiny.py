"""A CustomVoice configuration at tiny widths, for the CPU tests: the real
ids (text specials, codec specials, speakers) and vocabularies, narrow
layers and a narrow vocoder with the real 1920x upsampling."""

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def tiny_cfg(name: str = "cv06b-int8", projection: bool = False) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    t = cfg["talker_config"]
    h = 128 if projection else 64
    t.update(hidden_size=h, text_hidden_size=h, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16)
    t["code_predictor_config"].update(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                                      num_attention_heads=4, num_key_value_heads=2, head_dim=16)
    cfg["decoder_config"].update(latent_dim=16, codebook_dim=16, decoder_dim=32, hidden_size=16,
                                 intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
                                 num_key_value_heads=2, head_dim=8)
    return cfg
