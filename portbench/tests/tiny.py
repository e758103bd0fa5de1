"""A tiny serving cell for CPU tests: the 150M configuration file cut to
minute widths, the closed64 traffic cut to 4 clients and short requests."""

import copy
import json

from portbench.registry import HERE, Cell

TINY_MODEL = dict(dim=64, n_head=4, n_local_heads=2, intermediate_size=128, n_layer=2,
                  fast_dim=64, fast_n_head=4, fast_n_local_heads=2, fast_intermediate_size=128,
                  n_fast_layer=2, max_seq_len=128, dropout=0.0)
TINY_CODEC = dict(hidden_size=32, num_filters=4, num_hidden_layers=2, num_attention_heads=2,
                  head_dim=16, intermediate_size=64, codebook_dim=16, num_quantizers=8,
                  upsample_groups=32, sliding_window=10)


def tiny_config():
    conf = copy.deepcopy(json.loads((HERE / "configs" / "smoltts_150m.json").read_text()))
    conf["model"].update(TINY_MODEL)
    conf["codec"].update(TINY_CODEC)
    return conf


def tiny_cell(loop="closed", limits=None):
    traffic = json.loads((HERE / "traffic" / "closed64.json").read_text())
    traffic.update(loop=loop, clients=4, rate=6.0, lead_in_s=1.0, trace_s=0.5,
                   text_bytes={"median": 20, "sigma": 0.6, "min": 10, "max": 40},
                   frames={"bytes_per_s": 15, "frame_s": 0.08, "min": 4, "max": 12})
    traffic["engine"].update(num_slots=4, max_seq_len=128, attend_buckets=[64, 128])
    limits = limits or {"token_gap": 0.05, "pcm_err": 0.05}
    return Cell("tiny", 1, "tiny", tiny_config(), "tiny", traffic,
                {"check": {"requests": 3, "limits": limits}}, [], [])


def tiny_train_cell(limits=None):
    conf = tiny_config()
    job = json.loads((HERE / "configs" / "smoltts_70m.json").read_text())["training"]
    conf["training"] = dict(job, batch_size=4, max_sequence_length=64)
    traffic = json.loads((HERE / "traffic" / "train_22x768.json").read_text())
    # from tiny runs on the CPU: the program read loss_gap <= 2.7e-5,
    # grad_gap <= 0.0061, update_gap <= 0.0012 on three seeds; the fp8
    # control loss_gap >= 7.7e-5; half the batch left out grad_gap >= 0.06
    limits = limits or {"loss_gap": 5e-5, "grad_gap": 0.03, "update_gap": 0.02}
    return Cell("tiny_train", 1, "tiny", conf, "tiny", traffic,
                {"check": {"limits": limits}}, [], [])


def tiny_library_cell(limits=None):
    """The library loads the released Mimi shapes, so only the LM is cut."""
    conf = tiny_config()
    conf["codec"] = json.loads((HERE / "configs" / "smoltts_150m.json").read_text())["codec"]
    traffic = json.loads((HERE / "traffic" / "library_b1.json").read_text())
    traffic.update(lead_in_s=0.0, text_bytes={"median": 20, "sigma": 0.6, "min": 10, "max": 40},
                   frames={"bytes_per_s": 15, "frame_s": 0.08, "min": 4, "max": 12,
                           "flush_reach": 34})
    limits = limits or {"token_gap": 0.05, "pcm_err": 0.05}
    return Cell("tiny_b1", 1, "tiny", conf, "tiny", traffic,
                {"check": {"requests": 3, "limits": limits}}, [], [])
