"""What the per-layer readers of the one-shot codec call's stages share:
the program's own `ec_codec_call_stage_seconds{stage, backend}` (h2d,
kernel and d2h in `TorchCodec.coded_matmul`, compare in
`ReedSolomon.verify`), read through the program's metrics registry.

Each scrub pass makes one `verify` call and so one one-shot encode; the
seal at set-up streams and makes none. The counters hold the process's
whole life, so the mean per call includes the set-up's one warm-up
pass, 1 of about 25 calls in a 51 s window. Both cells' traffic names
the codec `cuda`."""
BACKEND = "cuda"


def seconds_per_GB(record, stage: str):
    """The stage's mean seconds per call, times the window's passes,
    over the window's GB; None when the stage was never recorded (the
    control, or a program that does not record it)."""
    from seaweedfs_tpu_torch.utils import metrics

    labels = {"stage": stage, "backend": BACKEND}
    count = metrics.counter_value("ec_codec_call_stage_seconds_count",
                                  labels)
    if not count or not record["bytes"]:
        return None
    mean = metrics.counter_value("ec_codec_call_stage_seconds_sum",
                                 labels) / count
    return mean * record["attempted"] / (record["bytes"] / 1e9)
