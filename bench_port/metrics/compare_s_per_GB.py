"""Seconds per GB the scrub verified that `ReedSolomon.verify` spent
comparing the computed parity with the stored parity rows on the host:
the program's `ec_codec_call_stage_seconds{stage="compare"}`, host clock
(call_stages.py)."""
from bench_port.call_stages import seconds_per_GB


def read(record):
    return seconds_per_GB(record, "compare")
