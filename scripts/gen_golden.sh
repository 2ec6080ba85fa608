#!/usr/bin/env bash
# Regenerate golden vectors from the reference C++ binaries.
#
# The reference implementation is built OUT of tree (it is the behavioral
# oracle only; no reference code enters this repo).  Small fixtures are
# committed under tests/golden/ so the test suite runs standalone.
#
# Usage: scripts/gen_golden.sh [REF_DIR] [OUT_DIR]
set -euo pipefail

REF=${1:-/root/reference}
OUT=${2:-$(dirname "$0")/../tests/golden}
BUILD=$(mktemp -d)
trap 'rm -rf "$BUILD"' EXIT

mkdir -p "$OUT" "$BUILD/bin"
g++ -std=c++17 -O3 -o "$BUILD/bin/opv-mod"   "$REF/src/opv-mod.cpp"   -lm
g++ -std=c++17 -O3 -o "$BUILD/bin/opv-demod" "$REF/src/opv-demod.cpp" -lm

# 1. BERT capture: 3 frames, callsign W5NYV, default token
"$BUILD/bin/opv-mod" -S W5NYV -B 3 > "$OUT/bert3.iq" 2>/dev/null

# 2. Reference demod of that capture -> decoded frames (bit-exact target)
"$BUILD/bin/opv-demod" -s -r -q < "$OUT/bert3.iq" > "$OUT/bert3.frames"

# 3. Raw-mode round trip input: 3 deterministic pseudo-random frames
python3 - "$OUT" <<'EOF'
import sys, random, pathlib
out = pathlib.Path(sys.argv[1])
rng = random.Random(0xC0FFEE)
data = bytes(rng.randrange(256) for _ in range(3 * 134))
(out / "raw3.bin").write_bytes(data)
EOF
"$BUILD/bin/opv-mod" -R < "$OUT/raw3.bin" > "$OUT/raw3.iq" 2>/dev/null
"$BUILD/bin/opv-demod" -s -r -q < "$OUT/raw3.iq" > "$OUT/raw3.frames"

# 4. Carrier-offset capture: 6 BERT frames shifted by +500 Hz, plus the
#    reference's decode of it (parity target incl. AFC convergence losses)
"$BUILD/bin/opv-mod" -S W5NYV -B 6 > "$BUILD/bert6.iq" 2>/dev/null
python3 - "$BUILD/bert6.iq" "$OUT/cfo500.iq" <<'EOF'
import sys, numpy as np
raw = np.fromfile(sys.argv[1], dtype="<i2").reshape(-1, 2)
s = raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)
n = np.arange(len(s))
s = s * np.exp(2j * np.pi * 500.0 * n / 2168000.0)
out = np.empty_like(raw)
out[:, 0] = np.clip(np.trunc(s.real), -32768, 32767).astype(np.int16)
out[:, 1] = np.clip(np.trunc(s.imag), -32768, 32767).astype(np.int16)
out.astype("<i2").tofile(sys.argv[2])
EOF
"$BUILD/bin/opv-demod" -s -r -q < "$OUT/cfo500.iq" > "$OUT/cfo500.frames"
# DSP-tunable variants: custom AFC bandwidth and explicit initial offset
"$BUILD/bin/opv-demod" -s -r -q -a 0.01 < "$OUT/cfo500.iq" > "$OUT/cfo500_a01.frames"
"$BUILD/bin/opv-demod" -s -r -q -o 500 < "$OUT/cfo500.iq" > "$OUT/cfo500_o500.frames"

# 5. AWGN capture: 6 BERT frames at Eb/N0 = 10 dB (seeded), + reference decode
python3 - "$BUILD/bert6.iq" "$OUT/awgn10.iq" <<'EOF'
import sys, numpy as np
raw = np.fromfile(sys.argv[1], dtype="<i2").reshape(-1, 2)
s = raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)
sig_pow = np.mean(np.abs(s) ** 2)
ebn0 = 10 ** (10.0 / 10)
noise_pow = sig_pow / (ebn0 / 40.0)           # Eb/N0 = per-sample SNR * sps
rng = np.random.default_rng(42)
s = s + (rng.standard_normal(len(s)) + 1j * rng.standard_normal(len(s))) * np.sqrt(noise_pow / 2)
out = np.empty_like(raw)
out[:, 0] = np.clip(np.trunc(s.real), -32768, 32767).astype(np.int16)
out[:, 1] = np.clip(np.trunc(s.imag), -32768, 32767).astype(np.int16)
out.astype("<i2").tofile(sys.argv[2])
EOF
"$BUILD/bin/opv-demod" -s -r -q < "$OUT/awgn10.iq" > "$OUT/awgn10.frames"

# 6. Sync-dropout capture: 8 BERT frames with frame 5's sync word zeroed —
#    exercises the LOCKED flywheel (collect payload through missed syncs)
"$BUILD/bin/opv-mod" -S W5NYV -B 8 > "$BUILD/bert8.iq" 2>/dev/null
python3 - "$BUILD/bert8.iq" "$OUT/dropout.iq" <<'EOF'
import sys, numpy as np
iq = np.fromfile(sys.argv[1], dtype="<i2").reshape(-1, 2).copy()
s0 = 4 * 86720
iq[s0:s0 + 960] = 0          # erase the 24-symbol sync of frame 5
iq.astype("<i2").tofile(sys.argv[2])
EOF
"$BUILD/bin/opv-demod" -s -r -q < "$OUT/dropout.iq" > "$OUT/dropout.frames"

# 7. Sample-clock drift capture: 8 BERT frames resampled at +200 ppm —
#    exercises the early-late timing-recovery loop
python3 - "$BUILD/bert8.iq" "$OUT/drift.iq" <<'EOF'
import sys, numpy as np
raw = np.fromfile(sys.argv[1], dtype="<i2").reshape(-1, 2)
s = raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)
ppm = 200e-6
n_out = int(len(s) / (1 + ppm)) - 2
t = np.arange(n_out) * (1 + ppm)
i0 = t.astype(np.int64)
f = t - i0
r = s[i0] * (1 - f) + s[i0 + 1] * f
out = np.empty((n_out, 2), dtype="<i2")
out[:, 0] = np.clip(np.trunc(r.real), -32768, 32767).astype(np.int16)
out[:, 1] = np.clip(np.trunc(r.imag), -32768, 32767).astype(np.int16)
out.tofile(sys.argv[2])
EOF
"$BUILD/bin/opv-demod" -s -r -q < "$OUT/drift.iq" > "$OUT/drift.frames"

# 8. FEC-waterfall captures: 12 BERT frames at Eb/N0 = 7 dB and 8 dB
#    (seeded), + the reference's decode of each — the knee where the
#    reference measures ~2.3e-2 post-FEC BER.  These
#    pin frame-for-frame parity at the waterfall, not just at 10 dB.
"$BUILD/bin/opv-mod" -S W5NYV -B 12 > "$BUILD/bert12.iq" 2>/dev/null
for DB in 7 8; do
python3 - "$BUILD/bert12.iq" "$OUT/awgn$DB.iq" "$DB" <<'EOF'
import sys, numpy as np
raw = np.fromfile(sys.argv[1], dtype="<i2").reshape(-1, 2)
db = float(sys.argv[3])
s = raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)
sig_pow = np.mean(np.abs(s) ** 2)
ebn0 = 10 ** (db / 10)
noise_pow = sig_pow / (ebn0 / 40.0)           # Eb/N0 = per-sample SNR * sps
rng = np.random.default_rng(int(db))
s = s + (rng.standard_normal(len(s)) + 1j * rng.standard_normal(len(s))) * np.sqrt(noise_pow / 2)
out = np.empty_like(raw)
out[:, 0] = np.clip(np.trunc(s.real), -32768, 32767).astype(np.int16)
out[:, 1] = np.clip(np.trunc(s.imag), -32768, 32767).astype(np.int16)
out.astype("<i2").tofile(sys.argv[2])
EOF
"$BUILD/bin/opv-demod" -s -r -q < "$OUT/awgn$DB.iq" > "$OUT/awgn$DB.frames"
done

ls -l "$OUT"
