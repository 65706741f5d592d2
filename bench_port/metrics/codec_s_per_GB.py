"""Seconds the codec's one-shot call took per GB the scrub verified: the
program's own `ec_codec_seconds{op="encode"}` over `ReedSolomon.verify`'s
encode (the upload from pageable memory, the kernel, the read-back)."""


def read(record):
    codec = record.get("codec_s")
    if not codec or not record["bytes"]:
        return None
    return codec / (record["bytes"] / 1e9)
