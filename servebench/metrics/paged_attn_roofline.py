"""The paged-attention kernels' share of their bytes roofline, in %: the KV
bytes the sub-window's decode steps had to read, over the kernels' device
time times the card's HBM bandwidth. The bytes come from the request handles
(each request's ``generated`` at the sub-window's two edges: every decode
step reads each key and value its query attends to, once per layer), so they
count what the inputs need, whatever implements it."""
from servebench import flops

# device kernels of kernels/csrc/paged_attention.cu (the split pass) and
# paged_attention_common.cuh (the merge pass), matched as substrings
KERNELS = ("paged_attention_kernel", "merge_splits_kernel")


def compute(record):
    t = record.trace
    if not t:
        return None
    secs = sum(s for name, s in t["kernel_s"].items()
               if any(k in name for k in KERNELS))
    start, end = t["edges"]["start"]["gen"], t["edges"]["end"]["gen"]
    need = 0
    for rid, (prompt_len, g1) in end.items():
        g0 = start.get(rid, (prompt_len, 0))[1]
        if g1 > g0:
            need += flops.decode_kv_bytes(record.model, prompt_len, g0, g1)
    if secs <= 0 or need <= 0:
        return None
    bw = flops.peaks(record.device_name)["hbm_bytes_per_s"]
    return 100.0 * need / (secs * bw)
