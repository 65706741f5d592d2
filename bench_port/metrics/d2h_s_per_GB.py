"""Seconds per GB the scrub verified that the one-shot codec call spent
reading the parity rows back into new pageable memory: the program's
`ec_codec_call_stage_seconds{stage="d2h"}`, timed with CUDA events
(call_stages.py)."""
from bench_port.call_stages import seconds_per_GB


def read(record):
    return seconds_per_GB(record, "d2h")
