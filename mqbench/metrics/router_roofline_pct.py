"""``router_roofline_pct``: the router's match kernels' least time on the
card over their traced time, in %, on up to ``SAMPLE`` launches of each
kernel spread over the traced window. The i-th launch a kernel wrapper
was called for is the i-th traced kernel of that name; its least time is
the larger of its bytes (every table, message and output tensor once)
over HBM bandwidth and its operations (``frozen/roofline.py``'s
``topic_work`` / ``headers_work`` on its own inputs) over the int32
peak."""

from mqbench.frozen import roofline

KERNELS = {"topic_match": "topic_match_kernel",
           "headers_match": "headers_match_kernel"}
SAMPLE = 200


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _work(name, table, args):
    np_ = [a.cpu().numpy() for a in args]
    if name == "topic_match":
        pre_m, suf_m, mlen = args
        tensors = (table.pre, table.suf, table.plen, table.slen,
                   table.has_hash, table.masks, pre_m, suf_m, mlen)
        ops, _ = roofline.topic_work(
            *(t.cpu().numpy() for t in tensors[:6]), *np_)
        rows = pre_m.shape[0]
    else:
        (pids,) = args
        tensors = (table.req, table.rcount, table.is_all, table.masks, pids)
        ops, _ = roofline.headers_work(
            *(t.cpu().numpy() for t in tensors[:4]), *np_)
        rows = pids.shape[0]
    out = rows * table.masks.shape[1] * 4
    return roofline.bound_s(_nbytes(*tensors) + out, ops, roofline.INT32_OPS)


def read(r: dict):
    t, calls = r.get("trace"), r.get("router_calls")
    if t is None or not calls:
        return None
    least = spent = 0.0
    for name, symbol in KERNELS.items():
        mine = [(table, args) for n, table, args in calls if n == name]
        times = [s for n, ss in t["launch_seconds"].items()
                 if symbol in n for s in ss]
        n = min(len(mine), len(times))
        if n == 0:
            continue
        step = max(1, n // SAMPLE)
        for i in range(0, n, step):
            least += _work(name, *mine[i])
            spent += times[i]
    return 100.0 * least / spent if spent > 0 else None
