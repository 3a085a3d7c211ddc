"""The port's examples (``examples_torch/``) through their ``main`` on the
CPU at cut sizes: what each prints is what the reference's example
claims (``examples/``): the collectives agree with the sum and F3 is
bitwise, every gradient transport trains, the end-to-end example's
losses fall and its checkpoints are written, the server answers every
request.  Without a card, their default ``--device cuda`` is refused."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    out = _example("quickstart").main(["--device", "cpu"])
    for alg in ("ring", "rhd", "fixed_tree", "two_level", "psum", "auto"):
        assert out[alg] <= 1e-5, alg
    assert out["f3_bitwise"] is True
    assert 0 < out["nnz"] < 1 << 16
    assert out["int8_rel_err"] < 0.02
    assert out["ingress_packets"] > 0 and out["incidents"]
    text = capsys.readouterr().out
    assert "run1 == run2 bitwise: True" in text
    assert "congestion_drift" in text


def test_sparse_allreduce_demo():
    out = _example("sparse_allreduce_demo").main(["--device", "cpu",
                                                  "--steps", "4"])
    assert set(out) == {"dense_ring", "reproducible", "int8", "sparse_1pct"}
    for name, r in out.items():
        assert np.isfinite(r["losses"]).all(), name
        assert r["losses"][-1] < r["losses"][0], name
    assert out["dense_ring"]["wire"] > out["int8"]["wire"] \
        > out["sparse_1pct"]["wire"]


def test_train_e2e(tmp_path, capsys):
    out = _example("train_e2e").main([
        "--device", "cpu", "--steps", "100", "--d-model", "32",
        "--layers", "1", "--batch", "4", "--seq", "16", "--vocab", "256",
        "--ckpt", str(tmp_path / "ck")])
    losses = out["losses"]
    assert len(losses) == 100 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert out["steps"] == [100]
    assert (tmp_path / "ck").is_dir()
    assert "checkpoints at" in capsys.readouterr().out


def test_serve_batched():
    reqs = _example("serve_batched").main(["--device", "cpu"])
    assert len(reqs) == 10 and all(r.done and r.out for r in reqs)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["quickstart", "sparse_allreduce_demo",
                                  "train_e2e", "serve_batched"])
def test_examples_refuse_a_missing_card(name):
    with pytest.raises(SystemExit, match="no CUDA device"):
        _example(name).main([])
