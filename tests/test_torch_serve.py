"""The port's serve path against the JAX package, on the CPU.

Same parameters on both sides (the JAX package's `tf.init`, carried over
by `params_from_numpy`), smoke size, fp32, CADC linears. The port's
prefill and decode logits match the JAX model within 1e-4; its engine
emits the JAX engine's token streams on a Poisson workload; inside the
port the paged cache is bitwise equal to the dense one through eviction
and slot/block reuse; and its psum-sparsity tap reads the JAX tap's
gate-off fractions. The same engine serves internvl2-1b's patch prefix and
the MoE archs with the JAX engine's streams.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models.lm import transformer as jtf
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import steps as tsteps
from repro_torch.models.lm import transformer as ttf
from repro_torch.serve import (BlockAllocator, EngineConfig, ServeEngine,
                               poisson_workload)

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _setup(linear_impl="cadc", n_layers=6):
    jcfg = jsmoke("gemma3_1b", linear_impl=linear_impl, n_layers=n_layers)
    tcfg = tsmoke("gemma3_1b", linear_impl=linear_impl, n_layers=n_layers)
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.array, jparams)
    return jcfg, jparams, tcfg, tree


def _tparams(tree, tcfg):
    return ttf.params_from_numpy(tree, tcfg, device="cpu")


def _staggered_workload(vocab, n=3):
    rng = np.random.RandomState(7)
    return [(i, rng.randint(0, vocab, size=(3 + (i % 3),)).astype(np.int32),
             3) for i in range(n)]


def _run_port(tcfg, params, backend, workload, **kw):
    eng = ServeEngine(tcfg, params, EngineConfig(
        n_slots=2, max_len=32, block_size=16, backend=backend,
        record_logits=True, **kw), device="cpu")
    eng.run([(a, p.copy(), g) for a, p, g in workload])
    return eng


class TestModelParity:
    @pytest.mark.parametrize("n_layers", [6, 8])
    def test_params_layout(self, n_layers):
        """units[j][r] -> layer r*len(pattern)+j, tail[i] after them."""
        jcfg, _, tcfg, tree = _setup(n_layers=n_layers)
        params = _tparams(tree, tcfg)
        assert len(params["layers"]) == n_layers
        p = len(jcfg.pattern)
        reps = n_layers // p
        for i, layer in enumerate(params["layers"]):
            src = (jax.tree_util.tree_map(lambda a: a[i // p],
                                          tree["units"][i % p])
                   if i < reps * p else tree["tail"][i - reps * p])
            np.testing.assert_array_equal(layer["attn"]["wq"]["w"].numpy(),
                                          src["attn"]["wq"]["w"])
        assert params["layers"][0]["ffn"]["w_down"]["w"].shape == (
            2, tcfg.crossbar_size, tcfg.d_model)  # segmented [S, xbar, d]

    @pytest.mark.parametrize("linear_impl", ["cadc", "dense"])
    def test_prefill_logits_match_jax(self, linear_impl):
        jcfg, jparams, tcfg, tree = _setup(linear_impl)
        tokens = np.random.RandomState(0).randint(
            0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
        want, contribs = jtf.forward_prefill(jparams,
                                             {"tokens": jnp.asarray(tokens)},
                                             jcfg)
        got, tcontribs = ttf.forward_prefill(
            _tparams(tree, tcfg), {"tokens": torch.from_numpy(tokens)}, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        k_j = np.asarray(contribs["units"][5][0][0])     # layer 5 (global) k
        np.testing.assert_allclose(tcontribs[5][0].numpy(), k_j, **TOL)

    def test_decode_logits_match_jax(self):
        """Token-by-token decode through the dense ring caches at per-slot
        positions, past the local window (ring wrap)."""
        jcfg, jparams, tcfg, tree = _setup()
        params = _tparams(tree, tcfg)
        b, ml = 2, 48
        jcaches = jtf.init_caches(jcfg, b, ml)
        tcaches = ttf.init_caches(tcfg, b, ml, device="cpu")
        jstep = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
        rng = np.random.RandomState(1)
        offsets = np.array([0, 3], np.int32)
        for step in range(36):
            tok = rng.randint(0, jcfg.vocab_size, size=(b,)).astype(np.int32)
            pos = offsets + step
            want, jcaches = jstep(jparams, jnp.asarray(tok),
                                  jnp.asarray(pos), jcaches)
            got = ttf.decode_step(params, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcaches, tcfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_default_kernel_impl_resolves_to_plain_on_cpu(self):
        """kernel_impl defaults to 'auto', which on CPU tensors is the plain
        segmented linear: bitwise the 'torch' path, and no kernel launch."""
        from repro_torch.kernels import cadc_matmul as tcm
        from repro_torch.kernels import ops as tops

        _, _, tcfg, tree = _setup()
        assert tcfg.kernel_impl == "auto"
        assert tops.resolve(tcfg.kernel_impl, torch.zeros(1)) == "torch"
        params = _tparams(tree, tcfg)
        tokens = {"tokens": torch.arange(1, 13).reshape(2, 6)}
        before = tcm.cadc_matmul_cuda.launches
        auto, _ = ttf.forward_prefill(params, tokens, tcfg)
        plain, _ = ttf.forward_prefill(
            params, tokens, tcfg.with_overrides(kernel_impl="torch"))
        assert torch.equal(auto, plain)
        assert tcm.cadc_matmul_cuda.launches == before

    def test_kernel_impl_auto_on_cpu_is_the_plain_path(self):
        _, _, tcfg, tree = _setup()
        params = _tparams(tree, tcfg)
        tokens = {"tokens": torch.arange(1, 13).reshape(2, 6)}
        plain, _ = ttf.forward_prefill(params, tokens, tcfg)
        auto, _ = ttf.forward_prefill(
            params, tokens, tcfg.with_overrides(kernel_impl="auto"))
        np.testing.assert_allclose(auto.numpy(), plain.numpy(), **TOL)


class TestEngineParity:
    @pytest.mark.parametrize("prefill_mode", ["batched", "decode"])
    def test_token_streams_match_jax_engine(self, prefill_mode):
        jcfg, jparams, tcfg, tree = _setup()
        wl = poisson_workload(n_requests=5, rate=1.0,
                              vocab_size=jcfg.vocab_size, prompt_len=(3, 9),
                              max_new=(2, 5), seed=4)
        ecfg = dict(n_slots=2, max_len=32, block_size=16,
                    prefill_mode=prefill_mode)
        jeng = JServeEngine(jcfg, jparams, JEngineConfig(**ecfg))
        jeng.run([(a, p.copy(), g) for a, p, g in wl])
        teng = ServeEngine(tcfg, _tparams(tree, tcfg), EngineConfig(**ecfg),
                           device="cpu")
        teng.run([(a, p.copy(), g) for a, p, g in wl])
        assert sorted(teng.results) == sorted(jeng.results)
        for rid in jeng.results:
            assert teng.results[rid].tokens == jeng.results[rid].tokens, rid

    @pytest.mark.parametrize("prefill_mode", ["batched", "decode"])
    def test_paged_bit_identical_to_dense(self, prefill_mode):
        _, _, tcfg, tree = _setup()
        params = _tparams(tree, tcfg)
        wl = _staggered_workload(tcfg.vocab_size)
        paged = _run_port(tcfg, params, "paged", wl,
                          prefill_mode=prefill_mode)
        dense = _run_port(tcfg, params, "dense", wl,
                          prefill_mode=prefill_mode)
        assert sorted(paged.results) == sorted(dense.results)
        for rid in paged.results:
            rp, rd = paged.results[rid], dense.results[rid]
            assert rp.tokens == rd.tokens
            for lp, ld in zip(rp.logits, rd.logits):
                assert np.array_equal(lp, ld)
        stats = paged.tables.stats()
        assert any(s["total_allocs"] > s["pool_blocks"]
                   for s in stats.values())
        assert all(s["free"] == s["pool_blocks"] for s in stats.values())

    def test_psum_gate_off_matches_jax_tap(self):
        """Telemetry every step on a workload that keeps every slot busy at
        every probe: per-layer gate-off and exact-zero fractions agree with
        the JAX tap (its unstacked probe labels layers tailNN; the port's
        are layerNN)."""
        jcfg, jparams, tcfg, tree = _setup()
        rng = np.random.RandomState(5)
        wl = [(0, rng.randint(0, jcfg.vocab_size, size=(5,)).astype(np.int32),
               4) for _ in range(2)]
        ecfg = dict(n_slots=2, max_len=32, block_size=16, telemetry_every=1)
        jeng = JServeEngine(jcfg, jparams, JEngineConfig(**ecfg))
        jeng.run([(a, p.copy(), g) for a, p, g in wl])
        teng = ServeEngine(tcfg, _tparams(tree, tcfg), EngineConfig(**ecfg),
                           device="cpu")
        teng.run([(a, p.copy(), g) for a, p, g in wl])
        jsp = jeng.telemetry.summary()["psum_sparsity"]
        tsp = teng.telemetry.summary()["psum_sparsity"]
        assert len(tsp) == len(jsp) == 7 * tcfg.n_layers
        for label, rec in jsp.items():
            mine = tsp[label.replace("tail", "layer")]
            assert mine["samples"] == rec["samples"] == 3
            assert mine["segments"] == rec["segments"]
            assert abs(mine["gate_off"] - rec["gate_off"]) < 1e-6, label
            assert abs(mine["exact_zero"] - rec["exact_zero"]) < 1e-6, label

    def test_psum_tap_ignores_idle_slots(self):
        """The port's tap counts the rows of active slots only: an extra
        idle slot leaves every statistic unchanged."""
        _, _, tcfg, tree = _setup()
        params = _tparams(tree, tcfg)
        rng = np.random.RandomState(5)
        wl = [(0, rng.randint(0, tcfg.vocab_size, size=(5,)).astype(np.int32),
               4) for _ in range(2)]
        stats = []
        for n_slots in (2, 3):
            eng = ServeEngine(tcfg, params, EngineConfig(
                n_slots=n_slots, max_len=32, block_size=16,
                telemetry_every=1), device="cpu")
            eng.run([(a, p.copy(), g) for a, p, g in wl])
            stats.append(eng.telemetry.summary()["psum_sparsity"])
        assert stats[0].keys() == stats[1].keys()
        for label in stats[0]:
            for key in ("gate_off", "exact_zero"):
                assert abs(stats[0][label][key] - stats[1][label][key]) < 1e-6

    def test_probe_leaves_caches_unchanged(self):
        _, _, tcfg, tree = _setup()
        params = _tparams(tree, tcfg)
        wl = _staggered_workload(tcfg.vocab_size)
        probed = _run_port(tcfg, params, "paged", wl, telemetry_every=1)
        plain = _run_port(tcfg, params, "paged", wl)
        for rid in plain.results:
            assert probed.results[rid].tokens == plain.results[rid].tokens
            for a, b in zip(probed.results[rid].logits,
                            plain.results[rid].logits):
                assert np.array_equal(a, b)

    def test_dense_linears_tap_nothing(self):
        _, _, tcfg, tree = _setup("dense")
        eng = _run_port(tcfg, _tparams(tree, tcfg), "paged",
                        _staggered_workload(tcfg.vocab_size, n=2),
                        telemetry_every=1)
        assert "psum_sparsity" not in eng.telemetry.summary()


class TestScheduling:
    def test_slot_reuse_under_load(self):
        _, _, tcfg, tree = _setup()
        wl = poisson_workload(n_requests=8, rate=1.5,
                              vocab_size=tcfg.vocab_size, prompt_len=(2, 6),
                              max_new=(2, 4), seed=3)
        eng = ServeEngine(tcfg, _tparams(tree, tcfg), EngineConfig(
            n_slots=2, max_len=32, block_size=16), device="cpu")
        summary = eng.run(wl)
        assert summary["requests_finished"] == 8
        for (_, _, g), rid in zip(wl, sorted(eng.results)):
            assert len(eng.results[rid].tokens) == g
        assert all(s["free"] == s["pool_blocks"]
                   for s in summary["blocks"].values())
        assert sum(summary["slot_uses"]) == 8
        assert max(summary["slot_uses"]) > 1
        assert summary["tokens_per_s"] > 0 and summary["ttft_ms_p50"] > 0

    def test_rejections(self):
        _, _, tcfg, tree = _setup()
        params = _tparams(tree, tcfg)
        eng = ServeEngine(tcfg, params, EngineConfig(
            n_slots=2, max_len=32, block_size=16), device="cpu")
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.zeros(30, np.int32), 10)
        with pytest.raises(ValueError, match="admitted"):
            ServeEngine(tcfg, params, EngineConfig(
                n_slots=2, max_len=32, block_size=16,
                n_blocks={"global": 1, "local": 1}), device="cpu")
        # speculative decoding needs the paged backend and batched prefill
        with pytest.raises(ValueError, match="paged"):
            ServeEngine(tcfg, params, EngineConfig(
                n_slots=2, max_len=32, block_size=16, backend="dense",
                spec_tokens=2), device="cpu")
        with pytest.raises(ValueError, match="batched"):
            ServeEngine(tcfg, params, EngineConfig(
                n_slots=2, max_len=32, block_size=16, prefill_mode="decode",
                spec_tokens=2), device="cpu")

    def test_unported_layer_kinds_raise(self):
        cfg = tsmoke("gemma3_1b").with_overrides(pattern=("global", "rglru"))
        with pytest.raises(NotImplementedError, match="rglru"):
            ttf.init(cfg, device="cpu")

    @pytest.mark.parametrize("override,match", [
        (dict(pattern=("mlstm", "slstm")), "mlstm"),
        (dict(frontend="audio", frontend_dim=48), "audio"),
        (dict(ffn_type="gelu"), "gelu")])
    def test_what_is_still_refused(self, override, match):
        """Recurrent and xLSTM kinds, the audio frontend and the gelu FFN
        are the port's refusals; MoE, qkv bias, untied heads and the vit
        prefix are served (tests/test_torch_lm_archs.py)."""
        cfg = tsmoke("gemma3_1b").with_overrides(**override)
        with pytest.raises(NotImplementedError, match=match):
            ttf.init(cfg, device="cpu")

    def test_block_allocator(self):
        a = BlockAllocator(4)
        got = a.alloc(3)
        assert sorted(got) == [0, 1, 2] and a.free_count == 1
        assert a.alloc(2) is None
        a.free(got)
        assert a.free_count == 4 and a.high_water == 3

    def test_serve_step_matches_decode_step(self):
        _, _, tcfg, tree = _setup()
        params = _tparams(tree, tcfg)
        step = tsteps.make_serve_step(tcfg)
        c1 = ttf.init_caches(tcfg, 2, 32, device="cpu")
        c2 = ttf.init_caches(tcfg, 2, 32, device="cpu")
        tok = torch.tensor([3, 4])
        nxt, logits = step(params, tok, 0, c1)
        want = ttf.decode_step(params, tok, torch.tensor(0), c2, tcfg)
        assert torch.equal(logits, want)
        assert torch.equal(nxt, torch.argmax(want, -1).to(torch.int32))

    def test_cli_on_cpu(self, capsys):
        summary = tserve_cli.main([
            "--arch", "gemma3_1b", "--smoke", "--cadc", "--slots", "2",
            "--requests", "3", "--prompt-len", "6", "--gen", "3",
            "--telemetry-every", "2", "--device", "cpu"])
        assert summary["requests_finished"] == 3
        out = capsys.readouterr().out
        assert "tok/s" in out and "psum gate-off" in out


@functools.lru_cache(maxsize=None)
def _setup_arch(arch):
    jcfg = jsmoke(arch, linear_impl="cadc")
    tcfg = tsmoke(arch, linear_impl="cadc")
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.array, jparams)
    return jcfg, jparams, tcfg, _tparams(tree, tcfg)


class TestVitPatches:
    """internvl2-1b's smoke config: image embeddings per request overlay
    the first frontend_len prompt positions in the batched prefill."""

    def _workload(self, cfg):
        rng = np.random.RandomState(9)
        out = []
        for i in range(3):
            prompt = rng.randint(0, cfg.vocab_size,
                                 size=cfg.frontend_len + i).astype(np.int32)
            patches = (None if i == 1 else rng.randn(
                cfg.frontend_len, cfg.frontend_dim).astype(np.float32))
            out.append((i, prompt, 3, patches))
        return out

    def test_patch_streams_match_jax_engine(self):
        """Three requests on two slots (one without patches: a zero image):
        the port's streams are the JAX engine's."""
        jcfg, jparams, tcfg, params = _setup_arch("internvl2_1b")
        wl = self._workload(jcfg)
        ecfg = dict(n_slots=2, max_len=32, block_size=16)
        jeng = JServeEngine(jcfg, jparams, JEngineConfig(**ecfg))
        teng = ServeEngine(tcfg, params, EngineConfig(**ecfg), device="cpu")
        for eng in (jeng, teng):
            for a, p, g, patches in wl:
                eng.submit(p.copy(), g, arrival_step=a, patches=patches)
            eng.run()
        assert sorted(teng.results) == sorted(jeng.results) == [0, 1, 2]
        for rid in jeng.results:
            assert teng.results[rid].tokens == jeng.results[rid].tokens, rid

    def test_patches_change_output_and_are_checked(self):
        """Distinct patches give distinct first-token logits (those
        positions are the image); a prompt shorter than the image, patches
        of another shape, patches for a text arch and the decode-mode
        prefill are refused."""
        _, _, tcfg, params = _setup_arch("internvl2_1b")
        prompt = np.arange(1, tcfg.frontend_len + 3, dtype=np.int32)
        outs = []
        for fill in (0.0, 0.5):
            eng = ServeEngine(tcfg, params, EngineConfig(
                n_slots=1, max_len=32, block_size=16, record_logits=True),
                device="cpu")
            eng.submit(prompt, 2, patches=np.full(
                (tcfg.frontend_len, tcfg.frontend_dim), fill, np.float32))
            eng.run()
            outs.append(eng.results[0].logits[0])
        assert not np.array_equal(outs[0], outs[1])
        image = np.zeros((tcfg.frontend_len, tcfg.frontend_dim), np.float32)
        with pytest.raises(ValueError, match="frontend_len"):
            eng.submit(np.arange(4, dtype=np.int32), 2, patches=image)
        with pytest.raises(ValueError, match="patches must be"):
            eng.submit(prompt, 2, patches=image[:, :-1])
        with pytest.raises(ValueError, match="batched"):
            ServeEngine(tcfg, params, EngineConfig(
                n_slots=1, max_len=32, prefill_mode="decode"), device="cpu")
        _, _, gcfg, gtree = _setup()
        text = ServeEngine(gcfg, _tparams(gtree, gcfg), EngineConfig(
            n_slots=1, max_len=32), device="cpu")
        with pytest.raises(ValueError, match="takes no patches"):
            text.submit(prompt, 2, patches=image)


class TestMoEStreams:
    @pytest.mark.parametrize("arch", ["mixtral_8x22b", "qwen2_moe_a27b"])
    def test_token_streams_match_jax_engine(self, arch):
        """Batched prefill (capacity over the padded rows, as in JAX) and
        MoE decode steps through admission and slot reuse."""
        jcfg, jparams, tcfg, params = _setup_arch(arch)
        wl = poisson_workload(n_requests=4, rate=1.0,
                              vocab_size=jcfg.vocab_size, prompt_len=(3, 9),
                              max_new=(2, 5), seed=4)
        ecfg = dict(n_slots=2, max_len=32, block_size=16)
        jeng = JServeEngine(jcfg, jparams, JEngineConfig(**ecfg))
        jeng.run([(a, p.copy(), g) for a, p, g in wl])
        teng = ServeEngine(tcfg, params, EngineConfig(**ecfg), device="cpu")
        teng.run([(a, p.copy(), g) for a, p, g in wl])
        assert sorted(teng.results) == sorted(jeng.results)
        for rid in jeng.results:
            assert teng.results[rid].tokens == jeng.results[rid].tokens, rid

    def test_cli_serves_moe_on_cpu(self, capsys):
        summary = tserve_cli.main([
            "--arch", "qwen2_moe_a27b", "--smoke", "--cadc", "--slots",
            "2", "--requests", "3", "--prompt-len", "6", "--gen", "3",
            "--device", "cpu"])
        assert summary["requests_finished"] == 3
        assert "arch=qwen2-moe-a2.7b" in capsys.readouterr().out
