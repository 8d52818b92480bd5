"""The twins of examples/quickstart.py and examples/serve_decode.py
(repro_torch.launch.quickstart, repro_torch.launch.serve_decode) at smoke
size on the CPU, where they run the kernels' plain versions.

  * the quickstart: the CADC matmul's plain version equal to the
    sequential oracle, no K1 launch, the relu psum sparsity of its seeded
    layer (half the psums, as the JAX quickstart's);
  * serve_decode: the dense run, then the CADC run with telemetry, each
    finishing its 8 requests; the CADC run reports psum sparsity.
"""
import torch

from repro_torch.launch import quickstart, serve_decode


def test_quickstart_runs_the_plain_path(capsys):
    out = quickstart.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["device"] == "cpu" and out["launches"] == 0
    assert out["kernel_err"] < quickstart.KERNEL_TOL
    assert 0.4 < out["sparsity"] < 0.6
    assert "no kernel runs" in printed and printed.rstrip().endswith("OK")


def test_serve_decode_serves_dense_then_cadc():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dense, cadc = serve_decode.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(prev)
    for summary in (dense, cadc):
        assert summary["requests_finished"] == 8
        assert summary["decode_tokens"] > 0
    assert "psum_sparsity" not in dense and cadc["psum_sparsity"]
