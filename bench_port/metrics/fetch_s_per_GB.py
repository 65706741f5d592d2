"""Seconds the scrub took per GB to gather the shards it verifies: each
shard's bytes whole, as its holder serves them, and the `np.stack` that
`ec_verify` builds of them (drivers.py ScrubDriver._fetch, host clock)."""


def read(record):
    fetch = record.get("fetch_s")
    if not fetch or not record["bytes"]:
        return None
    return fetch / (record["bytes"] / 1e9)
