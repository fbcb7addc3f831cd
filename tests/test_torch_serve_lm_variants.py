"""The port's ``serve_lm`` with each decode-variant flag as a replica and a
client in two processes, and its ``generate`` entry point.

For each of ``--quantize_weights``, ``--kv_cache_dtype int8``,
``--attn_window W --kv_cache_capacity C`` and ``--draft_preset tiny
--num_speculative k`` (greedy and sampled): ``serve_lm --device cpu
--listen`` in one process, ``--connect`` in another; every request
streams its budget, the replica's mode line names the variant, and the
client's first request streams the tokens an in-process batcher of the
same configuration gives it. SIGTERM drains the replica to exit 0.
"""

import os
import re
import signal
import subprocess
import sys

import pytest
import torch

from tony_tpu_torch import generate as G
from tony_tpu_torch import serve_lm
from tony_tpu_torch.models import decode as D
from tony_tpu_torch.models.serve import (ContinuousBatcher,
                                         SpeculativeContinuousBatcher)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SAMPLING = ["--temperature", "0.8", "--top_k", "50", "--top_p", "0.95"]
VARIANTS = {
    "int8-weights": (["--quantize_weights"], "greedy"),
    "int8-cache": (["--kv_cache_dtype", "int8"], "greedy"),
    "ring": (["--attn_window", "16", "--kv_cache_capacity", "24"],
             "greedy"),
    "speculative": (["--draft_preset", "tiny", "--num_speculative", "3"],
                    "speculative greedy"),
    "speculative-sampled": (["--draft_preset", "tiny", "--num_speculative",
                             "3", "--quantize_weights"] + SAMPLING,
                            "speculative sampled"),
}


def _serve_lm(*args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _in_process(flags, prompts, budgets):
    """The replica's batcher, built in this process from ``flags``."""
    val = lambda f, d: flags[flags.index(f) + 1] if f in flags else d
    cfg, params = serve_lm.build(
        "tiny", "cpu", quantize="--quantize_weights" in flags,
        kv_cache_dtype=val("--kv_cache_dtype", "model"),
        attn_window=int(val("--attn_window", 0)),
        kv_cache_capacity=int(val("--kv_cache_capacity", 0)))
    kw = dict(batch=2, max_len=48, seed=0,
              temperature=float(val("--temperature", 0)),
              top_k=int(val("--top_k", 0)), top_p=float(val("--top_p", 0)))
    if "--draft_preset" in flags:
        dcfg, dparams = serve_lm.build_draft(
            "tiny", cfg, "cpu", "--quantize_weights" in flags)
        b = SpeculativeContinuousBatcher(
            params, cfg, dparams, dcfg,
            num_speculative=int(val("--num_speculative", 4)), **kw)
    else:
        b = ContinuousBatcher(params, cfg, **kw)
    return b.serve(prompts, budgets)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_serve_lm_variant_replica_and_client_processes(variant):
    flags, mode = VARIANTS[variant]
    cfg = serve_lm.build("tiny", "cpu")[0]
    prompts, budgets = serve_lm.make_workload(0, 4, 16, 32, cfg.vocab_size)
    want = _in_process(flags, prompts, budgets)
    srv = _serve_lm("--device", "cpu", "--preset", "tiny", "--slots", "2",
                    *flags, "--listen", "127.0.0.1:0")
    try:
        line = srv.stdout.readline()
        if "--quantize_weights" in flags:
            assert "weight-only int8" in line, line
            line = srv.stdout.readline()
        m = re.search(rf"serving tiny \({mode}\) on (127\.0\.0\.1:\d+) "
                      rf"with 2 slots", line)
        assert m, line
        cli = _serve_lm("--preset", "tiny", "--requests", "4",
                        "--connect", m.group(1))
        out, _ = cli.communicate(timeout=240)
        assert cli.returncode == 0, out
        assert f"streamed 4 requests ({sum(budgets)} tokens)" in out, out
        assert f"first request tokens: {want[0][:12]}" in out, out
    finally:
        srv.send_signal(signal.SIGTERM)
        rest, _ = srv.communicate(timeout=120)
    assert srv.returncode == 0, rest


def test_serve_lm_closed_batch_names_speculation(capsys):
    assert serve_lm.main(["--device", "cpu", "--preset", "tiny",
                          "--requests", "3", "--slots", "2",
                          "--draft_preset", "tiny", "--num_speculative",
                          "2", "--kv_cache_dtype", "int8"]) == 0
    out = capsys.readouterr().out
    assert "— speculative greedy" in out, out
    assert re.search(r"speculative rounds: \d+ \([\d.]+ tokens/slot-round\)",
                     out), out


def test_generate_entry_point_sampled_and_beam(capsys):
    """``python -m tony_tpu_torch.generate --device cpu``: the sampled
    stream of ``--seed`` is ``decode.generate``'s, and ``--beam_width``
    prints the best beam of ``decode.beam_search``."""
    import numpy as np
    from tony_tpu_torch.ops import prng
    assert G.main(["--device", "cpu", "--max_new_tokens", "8"]) == 0
    out = capsys.readouterr().out
    cfg, params = serve_lm.build("tiny", "cpu")
    prompt = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 16)))
    want = D.generate(params, prompt, cfg, 8, rng=prng.PRNGKey(0),
                      temperature=0.8, top_k=40)
    assert f"sample token ids: {want.tokens[0, 16:].tolist()}" in out, out
    assert "generated (2, 24)" in out
    assert G.main(["--device", "cpu", "--max_new_tokens", "5",
                   "--beam_width", "3"]) == 0
    out = capsys.readouterr().out
    beams = D.beam_search(params, prompt, cfg, 5, beam_width=3)
    assert f"best beam token ids: {beams.tokens[0, 0, 16:].tolist()}" in out
    assert "beam search W=3: best-beam shape (2, 21)" in out, out

