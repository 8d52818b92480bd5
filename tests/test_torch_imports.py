"""The port stands alone: no jax, no repro.* imports in src/repro_torch/ or
chip_smoke.py (AST scan), nothing built at import, and entry points that
default to CUDA raise where there is none."""
import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_scan_covers_the_port():
    files = _port_files()
    assert os.path.join(REPO, "chip_smoke.py") in files
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_port_imports_without_building(tmp_path):
    """Every module imports on a machine with no nvcc and no card, and
    nothing is compiled or loaded while importing."""
    import importlib
    import pkgutil

    import repro_torch
    from repro_torch.kernels import _build

    before = _build.library.cache_info().currsize
    for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(mod.name)
    assert _build.library.cache_info().currsize == before


def test_cuda_sources_are_shipped():
    from repro_torch.kernels import _build

    for name in _build.SOURCES:
        src = _build.CSRC / name
        assert src.is_file()
        text = src.read_text()
        assert "sm_90a" in text and "Replaces the Pallas TPU kernel" in text


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_entry_points_default_to_cuda_and_raise(no_cuda):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.lm import transformer as tf
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = smoke_config("gemma3_1b", linear_impl="cadc")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.init(cfg)
    params = tf.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params, EngineConfig(n_slots=1, max_len=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.init_caches(cfg, 1, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--arch", "gemma3_1b", "--smoke", "--cadc"])


def test_registry_names_only_ported_archs():
    from repro_torch.configs import ARCH_IDS, get_config

    assert ARCH_IDS == ["gemma3_1b", "gemma_7b", "codeqwen15_7b",
                        "phi4_mini_38b", "mixtral_8x22b", "qwen2_moe_a27b",
                        "internvl2_1b"]
    cfg = get_config("gemma3-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
        26, 1152, 6912, 262144)
    moe = get_config("qwen2_moe_a27b")
    assert (moe.n_layers, moe.d_model, moe.vocab_size, moe.moe.n_experts,
            moe.moe.top_k, moe.moe.d_shared) == (24, 2048, 151936, 60, 4,
                                                 5632)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert cfg.kernel_impl == "auto" and cfg.paged_attn_impl == "auto"
    for arch in ("recurrentgemma_9b", "xlstm_13b", "hubert_xlarge"):
        with pytest.raises(ValueError, match="unknown arch"):
            get_config(arch)
