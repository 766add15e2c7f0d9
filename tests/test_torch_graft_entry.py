"""The port's driver entry points (findnpropagate_torch/graft_entry.py)
against the repository's `__graft_entry__.py` on the CPU.

entry(device="cpu") runs the JAX entry's forward on the JAX entry's own
batch and flax-initialised weights, carried across by from_jax_variables
(the JAX tiny config runs its sparse convs in gather mode, exact float32 in
both packages): boxes and scores within 1e-5 (tests/test_torch_transfusion.py's
tolerance), labels and counts exact. dryrun_multichip(2, device="cpu")
runs two gloo processes of one row each, and its loss equals, within 1e-5
relative, the loss of the port's one-process step over both rows. Without
CUDA and without a named device both raise.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from findnpropagate_torch import graft_entry
from findnpropagate_torch.runtime.trainer import make_train_step
from findnpropagate_torch.utils.weights import from_jax_variables

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import __graft_entry__ as jax_entry  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: tier-1 runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_the_reference_entry():
    jfn, (variables, jbatch) = jax_entry.entry()
    with jax.default_matmul_precision("highest"):
        want = [np.asarray(x) for x in jax.jit(jfn)(variables, jbatch)]
    fn, (det, batch) = graft_entry.entry(device="cpu")
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: tuple(np.shape(v)) for k, v in jbatch.items()}
    from_jax_variables(jax.tree.map(np.asarray, variables), det)
    got = [x.numpy() for x in fn(det, {k: torch.from_numpy(np.asarray(v))
                                       for k, v in jbatch.items()})]
    boxes, scores, labels, count = got
    np.testing.assert_array_equal(count, want[3])
    np.testing.assert_array_equal(labels, want[2])
    np.testing.assert_allclose(boxes, want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scores, want[1], rtol=1e-5, atol=1e-5)
    assert int(count.sum()) > 0
    # the port's own example runs too
    out = fn(det, batch)
    assert [tuple(o.shape) for o in out] == [w.shape for w in want]
    assert all(bool(torch.isfinite(o.float()).all()) for o in out)


def test_dryrun_equals_the_one_process_step(capsys):
    loss = graft_entry.dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss)
    assert "dryrun_multichip(2) OK: loss=" in capsys.readouterr().out
    det, tx, batch = graft_entry.train_setup(2, torch.device("cpu"))
    want = float(make_train_step(det, tx)(batch)["loss"])
    np.testing.assert_allclose(loss, want, rtol=1e-5)


def test_main_prints_the_output_shapes(capsys):
    assert graft_entry.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("entry OK: ((1, ")


def test_entry_points_raise_without_cuda_and_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
