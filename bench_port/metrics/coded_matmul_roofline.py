"""The coded product's share of its roofline, in %: the least time of the
bytes every product in the traced window must move ((k + m) * n each,
counted from the shapes the cell handed in; roofline.py), over the
device time of the product's kernels in the trace: those the traffic
mix names under `product_kernels` (csrc/coded_matmul.cu's). Any other
kernel's time is kept apart (devtrace.py `other_kernel_s`)."""
from bench_port.roofline import least_seconds


def read(record):
    trace = record.get("trace") or {}
    kernel_s = trace.get("kernel_s")
    least = least_seconds(record["product_bytes"], record["device_kind"])
    if not kernel_s or least is None:
        return None
    return 100.0 * least / kernel_s
