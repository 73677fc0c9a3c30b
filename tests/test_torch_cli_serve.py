"""PyTorch port: the CLI's ``serve`` and ``generate`` with sampling and
speculative decoding, against the JAX CLI, on the CPU (``--device cpu``).

Tolerances: greedy streams and verify-pass counts equal the JAX CLI's
printed lines, token for token (the same seeded LM, the same engine
arguments; tests/test_torch_paged.py and tests/test_torch_sampling.py hold
the engines and decoders to the JAX package's).  Sampled runs are held to
their own determinism only: torch cannot reproduce ``jax.random``'s
streams.
"""

import re

import pytest
import torch

from resnet_accel_tpu.cli import main as j_main
from resnet_accel_tpu_torch import cli

torch.set_num_threads(1)

SERVE = ["serve", "--n-new", "4", "--layers", "1", "--d-model", "64",
         "--heads", "2", "--max-len", "32", "--prompts", "1,2,3;4,5",
         "--pool-pages", "16"]
GEN = ["generate", "--layers", "1", "--d-model", "64", "--heads", "2",
       "--vocab", "37", "--max-len", "40", "--sparsity", "0.5", "--seed",
       "5", "--prompt", "3,14,15,9,3,14,15,9,3,14"]


def _lines(out: str, prefix: str):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def _port(capsys, argv):
    assert cli.main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr()


def _jax(capsys, argv):
    assert j_main(argv) == 0
    return capsys.readouterr()


@pytest.mark.parametrize("extra", [
    [],
    ["--reserve", "ondemand", "--prefix-cache", "--pool-pages", "6",
     "--page", "4", "--chunk", "4", "--prompts", "1,2,3,4,5,6,7,8,9;"
     "1,2,3,4,5,6,7,8,2;1,2,3,4,5,6,7,8,3"],
    ["--kv-dtype", "int8", "--spec-draft", "2"],
    ["--spec-draft", "3", "--spec-adaptive", "--slots", "3"]])
def test_serve_streams_and_counters_match_jax(capsys, extra):
    out = _port(capsys, SERVE + extra).out
    jout = _jax(capsys, SERVE + extra + ["--backend", "cpu"]).out
    reqs = _lines(out, "req ")
    assert reqs and reqs == _lines(jout, "req ")
    # the counter line, but for the host time and the device's name
    counters = out.splitlines()[-1].split("; ")[1:]
    assert counters == jout.splitlines()[-1].split("; ")[1:]
    assert "on cpu" in out.splitlines()[-1]


def test_serve_sampled_is_deterministic(capsys):
    argv = SERVE + ["--temperature", "3.0", "--top-k", "8",
                    "--sample-seed", "4", "--n-new", "8"]
    first = _lines(_port(capsys, argv).out, "req ")
    assert first == _lines(_port(capsys, argv).out, "req ")
    assert len(first) == 2


@pytest.mark.parametrize("extra,err", [
    (["--speculative", "--n-new", "12", "--top-k", "5"], "no effect"),
    (["--speculative", "--n-new", "12", "--draft", "40", "--flash"],
     "draft shrunk to 18")])
def test_generate_matches_jax(capsys, extra, err):
    port = _port(capsys, GEN + extra)
    jax_ = _jax(capsys, GEN + extra)
    for prefix in ("generated:", "speculative:"):
        assert _lines(port.out, prefix) == _lines(jax_.out, prefix)
    assert _lines(port.out, "generated:")
    # the greedy run's warning on --top-k, the draft shrink note
    assert port.err == jax_.err and err in port.err


def test_generate_sampled_speculative(capsys):
    argv = GEN + ["--speculative", "--n-new", "12", "--temperature", "0.8",
                  "--top-k", "40", "--sample-seed", "3"]
    out = _port(capsys, argv).out
    assert _lines(out, "generated:") == _lines(_port(capsys, argv).out,
                                               "generated:")
    assert re.search(r"speculative: \d+ verify passes for 12 tokens "
                     r"\(outputs distribution-exact vs sample\(\)\)", out)
    sampled = GEN + ["--n-new", "12", "--temperature", "0.8", "--top-k",
                     "40", "--sample-seed", "3"]
    assert _lines(_port(capsys, sampled).out, "generated:")


def test_generate_exits_as_jax():
    argv = GEN + ["--speculative", "--n-new", "30"]
    with pytest.raises(SystemExit) as jexit:
        j_main(argv)
    with pytest.raises(SystemExit) as exit_:
        cli.main([*argv, "--device", "cpu"])
    assert str(exit_.value) == str(jexit.value)
    assert "headroom" in str(exit_.value)


def test_serve_and_generate_default_to_cuda():
    p = cli.build_parser()
    for argv in (["serve"], ["generate", "--speculative"]):
        assert p.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["serve"])
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["generate", "--speculative", "--temperature", "0.8"])
