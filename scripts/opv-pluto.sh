#!/bin/bash
# opv-pluto.sh — full-duplex OPV PlutoSDR transceiver for opv_tpu.
#
# Wires Interlocutor <-> opv-modem (this framework's Python CLI) <-> PlutoSDR:
#   TX: opv-modem -t (UDP 57372 -> IQ) -> FIFO -> iio_writedev
#   RX: iio_readdev -> opv-modem -R (IQ -> UDP 57373)
# Radio config via iio_attr (AD9361), same numerology as the reference
# deployment (2.168 MSPS, one 40 ms frame per buffer).
#
# Functional equivalent of the reference's scripts/opv-pluto.sh (C22).
#
# One process per card: a JAX process that opens the GPU reserves most of
# its memory, so only the RX modem may take it (--rx-device gpu); the TX
# modem always runs on the CPU.

set -euo pipefail

SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"

PLUTO_URI="${PLUTO_URI:-ip:192.168.2.1}"
TX_FREQ=435000000
RX_FREQ=435000000
SAMPLE_RATE=2168000
TX_GAIN=-20
RX_GAIN=40
BUFFER_SIZE=346880            # one 40 ms frame of int16 IQ
TX_PORT=57372
RX_PORT=57373
VERBOSE=""
OPV_MODEM="${OPV_MODEM:-python3 -m opv_tpu.cli.opv_modem}"
RX_DEVICE="${RX_DEVICE:-cpu}"

usage() {
    cat <<EOF
Usage: $(basename "$0") [OPTIONS]
  -f, --frequency HZ    simplex frequency (default 435 MHz)
  --tx-freq HZ          TX frequency (split operation)
  --rx-freq HZ          RX frequency (split operation)
  --tx-gain DB          TX gain (default $TX_GAIN)
  --rx-gain DB          RX gain (default $RX_GAIN)
  -u, --uri URI         PlutoSDR URI (default $PLUTO_URI)
  --tx-port PORT        UDP port from Interlocutor (default $TX_PORT)
  --rx-port PORT        UDP port to Interlocutor (default $RX_PORT)
  --rx-device DEV       RX modem's jax platform: cpu or gpu (default
                        $RX_DEVICE; the TX modem stays on the CPU)
  -v, --verbose         verbose
  -h, --help            this help
EOF
    exit "${1:-0}"
}

while [[ $# -gt 0 ]]; do
    case "$1" in
        -f|--frequency) TX_FREQ="$2"; RX_FREQ="$2"; shift 2 ;;
        --tx-freq) TX_FREQ="$2"; shift 2 ;;
        --rx-freq) RX_FREQ="$2"; shift 2 ;;
        --tx-gain) TX_GAIN="$2"; shift 2 ;;
        --rx-gain) RX_GAIN="$2"; shift 2 ;;
        -u|--uri) PLUTO_URI="$2"; shift 2 ;;
        --tx-port) TX_PORT="$2"; shift 2 ;;
        --rx-port) RX_PORT="$2"; shift 2 ;;
        --rx-device) RX_DEVICE="$2"; shift 2 ;;
        -v|--verbose) VERBOSE="-v"; shift ;;
        -h|--help) usage ;;
        *) echo "Unknown option: $1" >&2; usage 1 ;;
    esac
done

for tool in iio_attr iio_readdev iio_writedev; do
    command -v "$tool" >/dev/null || { echo "Error: $tool not found (install libiio-utils)" >&2; exit 1; }
done
iio_info -u "$PLUTO_URI" >/dev/null 2>&1 || { echo "Error: cannot reach PlutoSDR at $PLUTO_URI" >&2; exit 1; }

TX_PID=""; RX_PID=""; IIO_TX_PID=""; IIO_RX_PID=""; TX_FIFO=""
cleanup() {
    echo "Shutting down..." >&2
    for pid in "$TX_PID" "$RX_PID" "$IIO_TX_PID" "$IIO_RX_PID"; do
        [[ -n "$pid" ]] && kill "$pid" 2>/dev/null || true
    done
    [[ -n "$TX_FIFO" && -p "$TX_FIFO" ]] && rm -f "$TX_FIFO"
}
trap cleanup EXIT INT TERM

echo "Configuring AD9361: TX=$TX_FREQ Hz RX=$RX_FREQ Hz @ $SAMPLE_RATE SPS" >&2
iio_attr -u "$PLUTO_URI" -c ad9361-phy altvoltage1 frequency "$TX_FREQ" >/dev/null
iio_attr -u "$PLUTO_URI" -c ad9361-phy altvoltage0 frequency "$RX_FREQ" >/dev/null
iio_attr -u "$PLUTO_URI" -c ad9361-phy voltage0 sampling_frequency "$SAMPLE_RATE" >/dev/null
iio_attr -u "$PLUTO_URI" -c ad9361-phy voltage0 rf_bandwidth "$SAMPLE_RATE" >/dev/null
iio_attr -u "$PLUTO_URI" -c -o ad9361-phy voltage0 hardwaregain "$TX_GAIN" >/dev/null
iio_attr -u "$PLUTO_URI" -c -i ad9361-phy voltage0 gain_control_mode manual >/dev/null
iio_attr -u "$PLUTO_URI" -c -i ad9361-phy voltage0 hardwaregain "$RX_GAIN" >/dev/null
# disable the DDS so the DMA path owns the TX chain
iio_attr -u "$PLUTO_URI" -c cf-ad9361-dds-core-lpc altvoltage0 raw 0 >/dev/null 2>&1 || true

# ---- TX path: UDP -> modem -> FIFO -> radio ----
TX_FIFO=$(mktemp -u /tmp/opv-tx-XXXX.fifo)
mkfifo "$TX_FIFO"
$OPV_MODEM -t -p "$TX_PORT" --device cpu $VERBOSE > "$TX_FIFO" &
TX_PID=$!
iio_writedev -u "$PLUTO_URI" -b "$BUFFER_SIZE" cf-ad9361-dds-core-lpc < "$TX_FIFO" &
IIO_TX_PID=$!

# ---- RX path: radio -> modem -> UDP ----
iio_readdev -u "$PLUTO_URI" -b "$BUFFER_SIZE" cf-ad9361-lpc voltage0 voltage1 | \
    $OPV_MODEM -R -r "$RX_PORT" --device "$RX_DEVICE" $VERBOSE &
RX_PID=$!

echo "OPV transceiver running: Interlocutor TX->udp:$TX_PORT, RX<-udp:$RX_PORT (Ctrl-C to stop)" >&2
wait "$RX_PID"
