"""Pallas-Triton Viterbi kernel and backend registry tests.

The kernel runs here through the Pallas interpreter; its compiled form is
checked bit-exact on the GPU by chip_smoke.py.  The lowering to Triton IR
needs no GPU, so it is checked here at full width too."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from opv_tpu.config import CONFIG
from opv_tpu.core.convcode import conv_encode_bits_np
from opv_tpu.ops import registry
from opv_tpu.ops.pallas.viterbi import BLOCK_FRAMES, viterbi_pallas
from opv_tpu.rx.viterbi import viterbi_decode_batch


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def _tie_stress(rng):
    """Low-entropy inputs that force massive metric ties."""
    return jnp.asarray(np.concatenate([
        rng.integers(0, 2, (4, CONFIG.encoded_bits)),
        np.zeros((2, CONFIG.encoded_bits)),
        np.full((2, CONFIG.encoded_bits), 7),
        rng.integers(3, 5, (2, CONFIG.encoded_bits))]).astype(np.int32))


@pytest.fixture
def backend():
    """Restore the registry's backend after a test flips it."""
    saved = registry._backend
    yield registry
    registry.set_backend(saved)


class TestPallasViterbi:
    def test_matches_xla_random(self):
        rng = np.random.default_rng(0)
        soft = jnp.asarray(rng.integers(0, 8, (5, CONFIG.encoded_bits))
                           .astype(np.int32))
        got = viterbi_pallas(soft, interpret=True)
        _assert_same(viterbi_decode_batch(soft), got)
        assert got[0].dtype == jnp.uint8 and got[0].shape == (5, 1072)

    def test_clean_decode(self):
        rng = np.random.default_rng(1)
        u = rng.integers(0, 2, (3, CONFIG.frame_bits)).astype(np.uint8)
        enc = conv_encode_bits_np(u)
        soft = jnp.asarray(np.where(enc == 1, 7, 0).astype(np.int32))
        bits, metrics = viterbi_pallas(soft, interpret=True)
        np.testing.assert_array_equal(np.asarray(bits), u)
        np.testing.assert_array_equal(np.asarray(metrics), 0)

    def test_batch_padding(self):
        """Batch sizes that are not multiples of block_frames are padded
        and cropped."""
        rng = np.random.default_rng(2)
        for b in (1, 32, 35):
            soft = jnp.asarray(rng.integers(0, 8, (b, CONFIG.encoded_bits))
                               .astype(np.int32))
            got = viterbi_pallas(soft, interpret=True, block_frames=32)
            assert got[0].shape[0] == b and got[1].shape == (b,)
            _assert_same(viterbi_decode_batch(soft), got)

    @pytest.mark.parametrize("block_frames", [32, 64, 128])
    def test_wide_tile_equivalence(self, block_frames):
        """Every tile width (frames per program) decodes identically to the
        XLA scan, on soft values beyond the 3-bit range too (int16 tape)."""
        rng = np.random.default_rng(6)
        soft = jnp.asarray(rng.integers(0, 256, (3, CONFIG.encoded_bits))
                           .astype(np.int32))
        _assert_same(viterbi_decode_batch(soft),
                     viterbi_pallas(soft, interpret=True,
                                    block_frames=block_frames))

    def test_tie_stress(self):
        """Ties prefer parent p0 in the ACS and the first minimum at the
        end state (opv-demod.cpp:836-837), exactly as the sequential scan."""
        soft = _tie_stress(np.random.default_rng(8))
        _assert_same(viterbi_decode_batch(soft),
                     viterbi_pallas(soft, interpret=True))

    def test_registry_dispatch(self, backend):
        soft = _tie_stress(np.random.default_rng(3))
        backend.set_backend("pallas_interpret")
        got = backend.viterbi_batch(soft)
        backend.set_backend("xla")
        _assert_same(backend.viterbi_batch(soft), got)
        assert got[0].dtype == jnp.uint8

    @pytest.mark.parametrize("block_frames", [-1, 48, 16])
    def test_rejects_bad_block_frames(self, block_frames):
        soft = jnp.zeros((2, CONFIG.encoded_bits), jnp.int32)
        with pytest.raises(ValueError, match="block_frames"):
            viterbi_pallas(soft, interpret=True, block_frames=block_frames)

    def test_lowers_to_triton_at_full_width(self):
        """The steady block's 1280-frame batch lowers to one Triton kernel
        call for CUDA (Triton IR is built without a GPU; only its PTX
        compile needs the card)."""
        soft = jax.ShapeDtypeStruct((1280, CONFIG.encoded_bits), jnp.int32)
        text = (jax.jit(viterbi_pallas).trace(soft)
                .lower(lowering_platforms=("cuda",)).as_text())
        assert text.count("__gpu$xla.gpu.triton") == 1
        assert "viterbi_acs_traceback" in text


class TestRegistry:
    def test_auto_is_xla_scan_on_cpu(self, backend):
        backend.set_backend("auto")
        assert backend.get_backend() == "xla"

    def test_pallas_raises_without_compiled_route(self, backend):
        backend.set_backend("pallas")
        with pytest.raises(RuntimeError, match="no compiled Viterbi kernel"):
            backend.get_backend()
        soft = jnp.zeros((2, CONFIG.encoded_bits), jnp.int32)
        with pytest.raises(RuntimeError):
            backend.viterbi_batch(soft)

    def test_rejects_unknown_backend(self, backend):
        with pytest.raises(ValueError):
            backend.set_backend("cuda_graph")

    def test_default_block_frames_is_power_of_two(self):
        assert BLOCK_FRAMES >= 32 and BLOCK_FRAMES & (BLOCK_FRAMES - 1) == 0

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_symbol_corr_float_accumulates_f32(self, dtype):
        rng = np.random.default_rng(5)
        sym = jnp.asarray(rng.standard_normal((2, 37, 80)), dtype)
        kern = jnp.asarray(rng.standard_normal((2, 80, 8)), jnp.float32)
        got = registry.symbol_corr(sym, kern)
        assert got.dtype == jnp.float32 and got.shape == (2, 37, 8)
        want = np.einsum("cst,cto->cso", np.asarray(sym, np.float64),
                         np.asarray(kern.astype(dtype), np.float64))
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                                   atol=1e-4)

    def test_symbol_corr_int8_is_exact(self):
        rng = np.random.default_rng(7)
        sym = rng.integers(-127, 128, (2, 37, 80)).astype(np.int8)
        kern = rng.integers(-127, 128, (2, 80, 8)).astype(np.int8)
        got = registry.symbol_corr(jnp.asarray(sym), jnp.asarray(kern))
        assert got.dtype == jnp.int32
        np.testing.assert_array_equal(
            np.asarray(got),
            np.einsum("cst,cto->cso", sym.astype(np.int64),
                      kern.astype(np.int64)))
