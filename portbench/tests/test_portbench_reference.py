"""Each plain reference agrees with the port's plain path at small sizes
on the CPU (this test imports both; the references import nothing of the
port)."""
import pytest
import torch

from portbench.drivers import _cnn, _lm
from portbench.reference import cnn as ref_cnn
from portbench.reference import lm as ref_lm
from portbench.tests import _small


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_lm_forward_and_prefill_equal_the_port():
    from repro_torch.launch import steps
    from repro_torch.models.lm import transformer as tf

    config, traffic, _ = _small.cell_parts("phi4mini-train-s2048")
    cfg = _lm.arch(config, traffic)
    w = _lm.draw(config, 3, "cpu", cfg.padded_vocab)
    tree = _lm.program_tree(w, cfg)
    tokens = torch.randint(0, config["vocab_size"], (2, 24),
                           generator=torch.Generator().manual_seed(0))
    got, _ = tf.forward_train(steps.cast_compute(tree, cfg),
                              {"tokens": tokens}, cfg)
    ref_w = ref_lm.weights(_lm.draw(config, 3, "cpu"))
    want = ref_lm.forward(ref_w, tokens, config, remat=False)
    assert _rel(got, want) < 1e-5
    logits, contribs = tf.forward_prefill(tree, {"tokens": tokens}, cfg)
    last, kv = ref_lm.prefill(ref_w, tokens[1, :17], config)
    assert _rel(logits[1, 16], last) < 1e-5
    for (k, v), (rk, rv) in zip(contribs, kv):
        assert _rel(k[1, :17], rk) < 1e-5 and _rel(v[1, :17], rv) < 1e-5


def test_lm_train_steps_equal_the_port():
    """The port's step and the reference's agree step by step: losses,
    step 1's clipped gradient by leaf, the change after three steps."""
    from portbench.harness import compare

    config, traffic, Cell = _small.cell_parts("phi4mini-train-s2048")
    from portbench.harness import spans

    work = Cell(config, traffic, 11, torch.device("cpu"), spans.Spans())
    work.release()
    n = work.check()
    assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-4
    assert n["update_gap"] < 1e-3
    assert set(n) >= {"loss_gap", "grad_gap", "update_gap"}
    assert compare.leaf_gap([1.0, 2.0], [1.0, 2.0]) == 0.0


def test_cnn_train_equals_the_port():
    from portbench.harness import spans

    config, traffic, Cell = _small.cell_parts("resnet18-train-b512")
    work = Cell(config, traffic, 5, torch.device("cpu"), spans.Spans())
    work.release()
    n = work.check()
    assert max(n.values()) < 1e-4, n


def test_q8_inference_equals_the_port_bitwise():
    from repro_torch.models.cnn import resnet18
    from repro_torch.models.common import Ctx

    from portbench.drivers import cnn_eval

    config, traffic, _ = _small.cell_parts("resnet18-q8-b1000")
    p, s = _cnn.draw(config, 4, "cpu")
    x = _cnn.images(config, traffic, 4, "cpu")[0]["image"]
    with torch.no_grad():
        got, _ = resnet18.apply(p, s, x, Ctx(cnn_eval.mode_of(config)),
                                train=False)
    want = ref_cnn.forward_q8(p, s, x, config)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", ["resnet18-train-b512",
                                  "phi4mini-train-s2048"])
def test_weights_are_a_function_of_the_seed(cell):
    config, _, _ = _small.cell_parts(cell)
    draw = _lm.draw if cell.startswith("phi4") else (
        lambda c, s, d: _cnn.draw(c, s, d)[0])
    a, b, c = (draw(config, s, "cpu") for s in (1, 1, 2))
    la = dict(_cnn.leaves(a)) if isinstance(a, dict) and "stem" in a else a
    lb = dict(_cnn.leaves(b)) if "stem" in b else b
    lc = dict(_cnn.leaves(c)) if "stem" in c else c
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not all(torch.equal(la[k], lc[k]) for k in la)


def test_a_layout_other_than_the_ports_is_refused():
    config, traffic, _ = _small.cell_parts("phi4mini-train-s2048")
    cfg = _lm.arch(config, traffic)
    tree = _lm.program_tree(_lm.draw(config, 3, "cpu", cfg.padded_vocab),
                            cfg)
    _lm.check_layout(_lm.shapes(tree), cfg)
    with pytest.raises(ValueError):
        _lm.check_layout(_lm.shapes(tree)[::-1], cfg)
