"""opv_tpu — a JAX/XLA/Pallas framework for the Opulent Voice
(OPV) amateur-radio digital voice modem.

Re-designed from scratch against the behavior of the reference C++ modem
(OpenResearchInstitute/opv-cxx-demod): MSK modulator, MSK demodulator with
AFC + symbol-timing recovery + soft-decision Viterbi, and a UDP modem server
— re-architected as batched, sharded accelerator computation.

Layout (see SURVEY.md for the reference layer map this mirrors):
  core/     numerology + codec chain (base40, LFSR, conv code, interleaver,
            frame encode/decode bit plumbing) as vectorized array ops
  tx/       MSK modulator (symbol state-machine scan + batched synthesis)
            and the TX frame multiplexer
  rx/       demodulator stages: CFO estimator, correlator/loop scan, sync
            tracker, Viterbi, frame finisher, feed-forward + locked-grid
            pipelines
  ops/      the Pallas-Triton Viterbi kernel for the GPU (+ XLA reference
            impls) and the backend registry
  stream/   streaming runtimes: single-channel parity, N-channel tracking,
            N-channel feed-forward overlap-save; checkpointable state
  parallel/ device-mesh sharding: channel-parallel, time-sharded blocks
            with halo exchange, multihost glue
  io/       sample I/O: int16 IQ wire format, UDP framing (host side)
  runtime/  native C extension for hot wire-format conversions
  cli/      CLI-compatible entry points (opv-mod / opv-demod / opv-modem)
"""

from opv_tpu.config import OPVConfig, CONFIG

__all__ = [
    "OPVConfig", "CONFIG",
    # lazy (see __getattr__): heavyweight imports deferred so CLI startup
    # and config-only users never pay the jax import cost
    "StreamingDemodulator", "MultiChannelDemodulator",
    "MultiChannelTrackingDemodulator",
    "rx_batch", "rx_fast", "rx_locked",
    "modulate_frames", "encode_frame", "build_bert_frame",
    "TxMultiplexer",
]
__version__ = "0.1.0"

_LAZY = {
    "StreamingDemodulator": "opv_tpu.stream",
    "MultiChannelDemodulator": "opv_tpu.stream",
    "MultiChannelTrackingDemodulator": "opv_tpu.stream",
    "rx_batch": "opv_tpu.rx.pipeline",
    "rx_fast": "opv_tpu.rx.fast",
    "rx_locked": "opv_tpu.rx.locked",
    "modulate_frames": "opv_tpu.tx",
    "encode_frame": "opv_tpu.core",
    "build_bert_frame": "opv_tpu.core",
    "TxMultiplexer": "opv_tpu.tx.multiplexer",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'opv_tpu' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
