"""attn_roofline.train: attention's bound (`segformer_count.attention_bound_ms`)
for the forwards and backwards its counters saw (ATTN_FWD and ATTN_GRAD calls
over the calls of one forward; a call with grad is a student's, whose
backward the step runs) over the device time of the attention kernels
(`segformer_count.ATTN_KERNELS`, by name), in %. Layer: kernels. Source:
device trace. None where the cell's counters or trace hold no attention."""
from benchmark import roofline, segformer_count
from benchmark.reference.segformer_rap import spec_of


def read(rec):
    t = rec["trace"]
    fwd, grad = t["launches"].get("ATTN_FWD"), t["launches"].get("ATTN_GRAD", 0)
    if rec["kind"] != "train" or not fwd or "embed_dims" not in rec["config"]:
        return None
    ms = sum(v for k, v in t["kernel_ms"].items()
             if any(p in k for p in segformer_count.ATTN_KERNELS))
    tr = rec["traffic"]
    b = segformer_count.attention_bound_ms(spec_of(rec["config"]), tr["batch"], tr["height"],
                                           tr["width"], rec["config"]["dtype"])
    bound = (fwd * b["fwd_ms"] + grad * b["bwd_ms"]) / b["calls"]
    return roofline.share(bound, ms)
