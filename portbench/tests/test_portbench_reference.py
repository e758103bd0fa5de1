"""The benchmark's plain reference against the port's plain paths at a tiny
size on the CPU: the DualAR logits (dense, teacher-forced), the served
tokens of the int8+kv8 decode path, and the Mimi decoder's PCM."""

import json

import numpy as np
import pytest
import torch

from portbench.reference.dual_ar import DualAR
from portbench.reference.mimi import MimiDecoder
from portbench.reference.quant import DENSE, Precision
from portbench.registry import HERE
from portbench.tests.tiny import tiny_config
from portbench.weights import dual_ar_specs, make_state, mimi_specs

from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.mimi import (
    decode_stream_init, mimi_decode, mimi_decode_step, params_from_hf_state_dict,
)
from smoltts_torch.config import DualARConfig
from smoltts_torch.io.checkpoint import params_from_state_dict
from smoltts_torch.lm.decode import decode_frame, init_decode_state, prefill
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.models.dual_ar import forward_train
from smoltts_torch.ops.quant import fuse_decode_params, quantize_decode_params
from smoltts_torch.tokenizer import TokenConfig

def token_cfg(conf):
    v = conf["vocab"]
    return TokenConfig(im_end_id=v["im_end"], pad_id=v["semantic_pad"],
                       semantic_start_id=v["semantic_start"],
                       semantic_end_id=v["semantic_start"] + conf["model"]["codebook_size"] - 1)


def random_grid(conf, T, seed):
    """[R, T] rows mixing text columns and semantic frames."""
    rng = np.random.default_rng(seed)
    m, v = conf["model"], conf["vocab"]
    tokens = np.zeros((m["num_codebooks"] + 1, T), np.int64)
    for t in range(T):
        if rng.random() < 0.4:
            tokens[0, t] = rng.integers(0, 256)
        else:
            codes = rng.integers(0, m["codebook_size"], m["num_codebooks"])
            tokens[0, t] = v["semantic_start"] + codes[0]
            tokens[1:, t] = codes
    return tokens


def test_dense_logits_match_the_ports_training_forward():
    conf = tiny_config()
    state = make_state(dual_ar_specs(conf["model"]), 5, "cpu", dtype=torch.float32)
    cfg = DualARConfig.from_dict(conf["model"])
    tokens = random_grid(conf, 40, 1)
    v = conf["vocab"]
    out = forward_train(params_from_state_dict(state, cfg), cfg, torch.from_numpy(tokens)[None],
                        embed_mask_mode="semantic_range", semantic_start_id=v["semantic_start"],
                        semantic_end_id=v["semantic_start"] + cfg.codebook_size - 1)
    ref = DualAR(state, conf["model"], v, DENSE, "cpu")
    h = ref.slow(torch.from_numpy(tokens))
    torch.testing.assert_close(ref.token_logits(h), out.token_logits[0], rtol=1e-4, atol=1e-4)
    codes = ref.code_logits(h[:-1], torch.from_numpy(tokens[1:, 1:].T))
    torch.testing.assert_close(codes, out.codebook_logits[0, :-1], rtol=1e-4, atol=1e-4)


def test_served_tokens_of_the_int8_kv8_decode_path_lie_at_the_references_best():
    """Greedy prefill + frames through the port's plain int8 / kv8 path;
    every served token within a small gap of the int8 reference's best."""
    conf = tiny_config()
    state = make_state(dual_ar_specs(conf["model"]), 6, "cpu", dtype=torch.float32)
    cfg = DualARConfig.from_dict(conf["model"])
    params = quantize_decode_params(fuse_decode_params(params_from_state_dict(state, cfg)))
    tok = token_cfg(conf)
    greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
    prompt = torch.from_numpy(random_grid(conf, 12, 2)[:, :12]).to(torch.int32)
    prompt[1:] = 0
    prompt[0] = torch.randint(0, 256, (12,), generator=torch.Generator().manual_seed(0))
    st = init_decode_state(cfg, 1, 64, dtype=torch.int8, tail_len=8, device="cpu")
    st, out = prefill(params, cfg, tok, greedy, st, prompt[None], torch.tensor([12]), None)
    frames = [out]
    for _ in range(5):
        st, out = decode_frame(params, cfg, tok, greedy, st, None)
        frames.append(out)
    served = torch.stack([torch.cat([o.slow_token, o.audio_codes[0]]) for o in frames]).long()
    ref = DualAR(state, conf["model"], conf["vocab"], Precision(8, 8, None), "cpu")
    slow, codes = ref.served_logits(prompt.long(), served)
    gap_slow = slow.max(-1).values - slow.gather(-1, served[:, :1])[:, 0]
    gap_codes = codes.max(-1).values - codes.gather(-1, served[:, 1:, None])[..., 0]
    assert float(gap_slow.max()) < 1e-3 and float(gap_codes.max()) < 1e-3


def _mimi(conf, seed):
    state = make_state(mimi_specs(conf["codec"]), seed, "cpu", dtype=torch.float32)
    mcfg = MimiConfig(**{k: v for k, v in conf["codec"].items()
                         if k in MimiConfig.__dataclass_fields__})
    return state, mcfg, params_from_hf_state_dict(state, mcfg)


def test_reference_vocoder_matches_the_ports_batch_decode():
    conf = tiny_config()
    state, mcfg, params = _mimi(conf, 7)
    codes = torch.randint(0, 2048, (1, 8, 30), generator=torch.Generator().manual_seed(1))
    want = mimi_decode(params, mcfg, codes)[0, :, 0]
    got = MimiDecoder(state, conf["codec"], DENSE, "cpu").decode(codes[0])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kv8", [False, True])
def test_reference_vocoder_matches_the_ports_streaming_decode(kv8):
    """Frame by frame through the port's streaming step (past the sliding
    window, with the int8 ring when kv8) against one whole-sequence decode."""
    conf = tiny_config()
    state, mcfg, params = _mimi(conf, 8)
    T = 30
    codes = torch.randint(0, 2048, (1, 8, T), generator=torch.Generator().manual_seed(2))
    ms = decode_stream_init(mcfg, 1, tail_len=8, kv_dtype=torch.int8 if kv8 else None,
                            device="cpu")
    from smoltts_torch.codec.mimi import flush_mimi_state

    pcm = []
    for t in range(T):
        if t % 3 == 0:
            ms = flush_mimi_state(ms)
        ms, p = mimi_decode_step(params, mcfg, ms, codes[:, :, t:t + 1])
        pcm.append(p[0, :, 0])
    got = torch.cat(pcm)
    ref = MimiDecoder(state, dict(conf["codec"], kv8_ring=kv8), Precision(None, 8, None),
                      "cpu").decode(codes[0])
    err = float(((got - ref) ** 2).mean().sqrt() / (ref ** 2).mean().sqrt())
    assert err < (1e-2 if kv8 else 1e-4)


def test_training_loss_gradients_and_update_match_the_ports_train_step():
    """Dropout on, the slow trunk at T=512 (its blockwise attention): the
    reference's three steps against the port's `make_train_step` in float32."""
    from portbench import check_train, data
    from portbench.drivers.train import leaf_names
    from smoltts_torch.config import TrainingConfig
    from smoltts_torch.train.trainer import init_train_state, make_train_step

    conf = tiny_config()
    conf["model"]["dropout"] = 0.1
    job = dict(json.loads((HERE / "configs" / "smoltts_70m.json").read_text())["training"],
               use_bf16=False, batch_size=2, max_sequence_length=512)
    conf["training"] = job
    state = make_state(dual_ar_specs(conf["model"]), 9, "cpu", dtype=torch.float32)
    cfg = DualARConfig.from_dict(conf["model"])
    params = params_from_state_dict({k: v.clone() for k, v in state.items()}, cfg)
    tc = TrainingConfig.from_dict({k: v for k, v in job.items() if k != "source"})
    ts, tx = init_train_state(params, tc)
    step = make_train_step(cfg, tc, tx)
    batches = data.batches(3, 2, 512, conf["model"], conf["vocab"], 4)
    seeds = [11, 2**62 - 5, 12345]
    names, leaves = leaf_names(ts.params), tx.param_groups[0]["params"]
    start = [p.detach().clone() for p in leaves]
    losses = []
    for i in range(3):
        ts, m = step(ts, batches[i], seeds[i])
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {n: float(tx.state[p]["mu"].norm() / (1 - tc.betas[0]))
                    for n, p in zip(names, leaves)}
    update = {n: float((p.detach() - s).norm()) for n, p, s in zip(names, leaves, start)}
    ref = check_train.reference_readings(conf, 9, batches, seeds, "cpu", dtype=torch.float32)
    got = check_train.gaps({"losses": losses, "grad": grad, "update": update}, ref)
    assert max(got.values()) < 1e-3, got
