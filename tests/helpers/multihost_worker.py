"""Multi-process worker for the multihost test (tests/test_multihost.py).

Run as: python multihost_worker.py <process_id> <num_processes> <port> \
            [local_devices=2] [ch=num_processes] [time=auto]

Each process owns `local_devices` virtual CPU devices; jax.distributed
stitches them into one (num_processes * local_devices)-device runtime.
global_mesh builds the (ch, time) mesh with each host's local devices
contiguous along `time` (host-local) and `ch` spanning hosts,
then rx_grid_sharded runs the full halo-exchange + psum pipeline across
the process boundary — the reference's "multi-node" analog is localhost
UDP/pipes (SURVEY.md section 4); ours is an actual jax.distributed
collective run.  Every channel carries a DISTINCT frame set so a
channel-indexing error anywhere in the mesh layout cannot cancel out.
"""

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

_LOCAL = int(sys.argv[4]) if len(sys.argv) > 4 else 2
os.environ["XLA_FLAGS"] = \
    f"--xla_force_host_platform_device_count={_LOCAL}"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ch = int(sys.argv[5]) if len(sys.argv) > 5 else nproc
    from opv_tpu.parallel.multihost import global_mesh, initialize_multihost

    initialize_multihost(f"127.0.0.1:{port}", num_processes=nproc,
                         process_id=pid)
    assert jax.process_count() == nproc
    assert jax.device_count() == _LOCAL * nproc

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.parallel.grid import rx_grid_sharded
    from opv_tpu.tx import modulate_frames, tx_flush_zeros

    tdim = (_LOCAL * nproc) // ch
    mesh = global_mesh(ch=ch, time=tdim)

    # every process synthesizes the identical capture (distinct frames per
    # channel), then contributes its addressable shards of the
    # (ch, T) global array
    per_ch = []
    fpc = 2                   # frames per channel
    for c in range(ch):
        frames = build_bert_frame("W5NYV",
                                  frame_num=np.arange(fpc) + 10 * c)
        enc = encode_frame(jnp.asarray(frames))
        iq, _ = modulate_frames(enc, exact=False)
        iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
        s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
        per_ch.append((np.asarray(frames), s))
    t = tdim * 87_680         # time shards at the minimum halo-legal size
    host = np.zeros((ch, t), np.complex64)
    for c, (_, s) in enumerate(per_ch):
        host[c, : min(t, len(s))] = s[:t]

    sharding = NamedSharding(mesh, P("ch", "time"))
    samples = jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx])

    out = rx_grid_sharded(mesh, samples, max_frames_per_shard=4)
    n = int(out["n"])
    expect = ch * fpc
    assert n == expect, f"process {pid}: decoded {n}, expected {expect}"

    # check the locally-addressable decoded payloads bit-exactly against
    # THEIR channel's transmitted set (shard.index[0] is the channel slice)
    for shard in out["frames"].addressable_shards:
        own = np.asarray(
            [np.asarray(sh.data) for sh in out["owned"].addressable_shards
             if sh.index == shard.index[:2]][0])
        got = np.asarray(shard.data)[own]
        c0 = shard.index[0].start or 0
        nch = np.asarray(shard.data).shape[0]
        per_row = own.reshape(nch, -1)
        k = 0
        for r in range(nch):
            expect_frames = per_ch[c0 + r][0]
            cnt = int(per_row[r].sum())
            for f in got[k:k + cnt]:
                assert any(np.array_equal(f, x) for x in expect_frames), \
                    f"process {pid}: payload mismatch on channel {c0 + r}"
            k += cnt
    print(f"MULTIHOST OK pid={pid} n={n} mesh={ch}x{tdim}", flush=True)


if __name__ == "__main__":
    main()
