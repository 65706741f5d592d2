"""Seconds per GB the scrub verified that the one-shot codec call spent
uploading the data rows from pageable memory: the program's
`ec_codec_call_stage_seconds{stage="h2d"}`, timed with CUDA events
(call_stages.py)."""
from bench_port.call_stages import seconds_per_GB


def read(record):
    return seconds_per_GB(record, "h2d")
