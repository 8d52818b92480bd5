"""The yardstick's frozen counts against hand counts."""
import pytest

from portbench.drivers import _cnn, _lm
from portbench.harness import costs


def test_matmul_forward_and_backward():
    p = costs.matmul("cadc", 4, 8, 16, "bfloat16")
    assert p.ops == 2 * 4 * 8 * 16
    assert p.bytes == (4 * 8 + 8 * 16 + 4 * 16) * 2
    b = costs.matmul("cadc", 4, 8, 16, "bfloat16", backward=True)
    assert b.ops == 4 * 4 * 8 * 16
    # g, x, w read; dx, dw written
    assert b.bytes == (4 * 16 + 4 * 8 + 8 * 16 + 4 * 8 + 8 * 16) * 2


def test_q8_product_reads_codes_writes_fp32():
    p = costs.matmul("q8", 10, 64, 3, "int8", out_dtype="float32")
    assert p.bytes == 10 * 64 + 64 * 3 + 10 * 3 * 4
    assert p.dtype == "int8"


def test_conv_counts_the_activation_not_its_patches():
    p = costs.conv("cadc", 2, 8, 8, 3, 16, 3, 1, "float32")
    assert p.ops == 2 * (2 * 8 * 8) * (3 * 3 * 3) * 16
    assert p.bytes == (2 * 8 * 8 * 3 + 27 * 16 + 2 * 8 * 8 * 16) * 4
    s2 = costs.conv("cadc", 2, 8, 8, 3, 16, 3, 2, "float32")
    assert s2.ops == 2 * (2 * 4 * 4) * 27 * 16
    dw = costs.conv("cadc", 2, 8, 8, 3, 16, 3, 1, "float32", backward=True,
                    dx=False)
    assert dw.ops == p.ops
    assert dw.bytes == (2 * 8 * 8 * 16 + 2 * 8 * 8 * 3 + 27 * 16) * 4


def test_least_time_is_the_larger_bound():
    big = costs.Product("cadc", 989e12, 1.0, "bfloat16")
    assert costs.least_s([big]) == pytest.approx(1.0)
    wide = costs.Product("cadc", 1.0, 3.35e12, "float32")
    assert costs.least_s([wide, big]) == pytest.approx(2.0)


@pytest.mark.parametrize("cell,over", [
    ("phi4mini-train-s2048", {"crossbar_size": 64, "kernel_impl": "plain"}),
    ("phi4mini-prefill-s256-2048", {"crossbar_size": 16, "remat": False}),
    ("resnet18-train-b512", {"crossbar_size": 32, "kernel": "plain"}),
    ("resnet18-q8-b1000", {"crossbar_size": 128, "kernel": "plain"}),
])
def test_counts_do_not_depend_on_the_route(cell, over):
    """A cell's count is a function of its shapes alone: the same under
    any crossbar or kernel setting."""
    from types import SimpleNamespace

    from portbench.tests import _small

    config, traffic, Cell = _small.cell_parts(cell)

    def count(cfg):
        # what products() reads of a cell: its sizes, and for the prefill
        # a call's rows and padded length
        me = SimpleNamespace(config=cfg, traffic=traffic,
                             shapes=[[8, 20, 40]], _s_pad=lambda i: 40)
        return Cell.products(me, 0)

    assert count({**config, **over}) == count(config)


def test_resnet18_forward_flops():
    c = {"width": 64, "stages": [2, 2, 2, 2], "image_hw": 32, "channels": 3,
         "num_classes": 10}
    # ResNet-18 (CIFAR) is ~0.556 GMACs an image
    assert _cnn.forward_flops(c) == pytest.approx(2 * 0.5559e9, rel=2e-3)
    assert len(_cnn.convs(c)) == 20


def test_phi4_mini_weights():
    c = {"hidden_size": 3072, "num_attention_heads": 24,
         "num_key_value_heads": 8, "intermediate_size": 8192,
         "vocab_size": 200064, "num_hidden_layers": 32}
    layer = sum(a * b for a, b in _lm.layer_shapes(c).values())
    # Phi-4-mini: 3.84 B parameters with the tied embedding
    assert 32 * layer + 200064 * 3072 == pytest.approx(3.836e9, rel=1e-3)
