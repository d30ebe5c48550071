"""The port's LM decode launcher (``python -m repro_torch.launch.serve
--arch``) against the reference's (``repro.launch.serve``): the same JSON
document, its sampled tokens those of the port's own ``make_decode_step``
loop, the reference's argument checks, and the history row."""
import json
import types

import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.obs.history import case_key
from repro_torch.models import (ExecConfig, init_caches, init_params,
                                make_decode_step)

pytestmark = pytest.mark.port

ARGS = ["--arch", "qwen2_7b", "--reduced", "--batch", "2", "--prompt-len",
        "6", "--gen", "5"]


def _args(argv, **kw):
    """The namespace ``main`` would build for ``argv``."""
    ns = dict(arch=None, case=None, reduced=False, batch=4, prompt_len=32,
              gen=16, temperature=0.0, json=None, device="cuda")
    it = iter(argv)
    for a in it:
        key = a[2:].replace("-", "_")
        ns[key] = True if key == "reduced" else next(it)
    for k in ("batch", "prompt_len", "gen"):
        ns[k] = int(ns[k])
    ns.update(kw)
    return types.SimpleNamespace(**ns)


def _own_loop(arch, batch, prompt_len, gen, temperature=0.0):
    """The launcher's loop written out with ``make_decode_step``."""
    cfg = get_config(arch).reduced()
    max_len = prompt_len + gen
    exec_cfg = ExecConfig(attn_chunk_q=32, attn_chunk_k=32, ssm_chunk=16)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    caches = init_caches(cfg, batch, max_len, device="cpu")
    step = make_decode_step(cfg, exec_cfg, max_len)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (batch, prompt_len))
    g = torch.Generator().manual_seed(1)
    for t in range(prompt_len):
        logits, caches = step(params, caches, prompts[:, t:t + 1], t)
    out = []
    tok = logits.argmax(-1)[:, None]
    for t in range(prompt_len, max_len):
        out.append(int(tok[0, 0]))
        logits, caches = step(params, caches, tok, t)
        if temperature > 0:
            tok = torch.multinomial(torch.softmax(logits / temperature, -1),
                                    1, generator=g)
        else:
            tok = logits.argmax(-1)[:, None]
    return out[:8]


def test_json_document_has_the_references_keys(tmp_path, capsys):
    want_path, got_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_serve.decode_arch(_args(ARGS, json=str(want_path)))
    doc = serve.decode_arch(_args(ARGS, json=str(got_path), device="cpu"))
    want = json.loads(want_path.read_text())
    got = json.loads(got_path.read_text())
    assert got == json.loads(json.dumps(doc, default=str))
    assert set(got) == set(want)
    for k in ("arch", "batch", "reduced", "prompt_len", "gen"):
        assert got[k] == want[k], k
    assert len(got["step_latency_us"]) == len(want["step_latency_us"]) == 5
    assert got["step_p50_us"] <= got["step_p90_us"]
    assert got["stamp"]["device"].startswith("cpu")
    assert "jax" not in got["stamp"]
    assert len(got["sample_tokens"]) == len(want["sample_tokens"]) == 5


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_sample_tokens_are_the_decode_step_loops(temperature, capsys):
    doc = serve.decode_arch(_args(ARGS, device="cpu",
                                  temperature=temperature))
    assert doc["sample_tokens"] == _own_loop("qwen2_7b", 2, 6, 5,
                                             temperature)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == doc
    assert doc["prefill_tok_s"] > 0 and doc["decode_tok_s"] > 0


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_9b",
                                  "deepseek_moe_16b"])
def test_every_decoding_family_serves(arch, capsys):
    doc = serve.decode_arch(_args(["--arch", arch, "--reduced", "--batch",
                                   "2", "--prompt-len", "4", "--gen", "3"],
                                  device="cpu"))
    assert doc["arch"] == get_config(arch).reduced().name
    assert len(doc["sample_tokens"]) == 3


def test_main_takes_arch_and_device(capsys):
    serve.main(ARGS + ["--device", "cpu", "--json", "-"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["arch"] == "qwen2-7b-reduced" and doc["batch"] == 2


@pytest.mark.parametrize("argv", [[], ["--arch", "qwen2_7b", "--case",
                                       "gaussian"]])
def test_exactly_one_of_case_or_arch(argv, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert "exactly one of --case" in capsys.readouterr().err


def test_encoder_has_no_decode():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.decode_arch(_args(["--arch", "hubert_xlarge", "--reduced"],
                                device="cpu"))


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.decode_arch(_args(ARGS))


def test_json_run_appends_a_history_row(tmp_path, monkeypatch, capsys):
    hist = tmp_path / "history.jsonl"
    monkeypatch.setenv("RACE_BENCH_HISTORY", str(hist))
    doc = serve.decode_arch(_args(ARGS, device="cpu", json="-"))
    rows = [json.loads(line) for line in hist.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["section"] == "serve"
    assert rows[0]["case"] == case_key(doc)
    assert {"decode_tok_s", "prefill_tok_s", "step_p50_us"} <= set(
        rows[0]["metrics"])
