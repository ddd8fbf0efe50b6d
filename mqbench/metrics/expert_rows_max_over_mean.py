"""``expert_rows_max_over_mean``: how uneven the router makes the experts'
work in the window: the largest expert group of each expert layer of each
train step (the service's ``moe_max_rows_sum`` counter, read on the
device) over the mean group (routed rows over the experts), averaged over
layers and steps. 1 is even; every group empty but one is the expert
count."""


def read(r: dict):
    moe = r.get("moe")
    if not moe or not moe.get("routed_rows"):
        return None
    return moe["max_rows_sum"] * moe["n_experts"] / moe["routed_rows"]
