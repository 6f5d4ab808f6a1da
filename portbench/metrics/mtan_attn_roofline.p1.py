"""`mtan_attn_roofline.p1`: % of their roofline: the bound of mTAN's encoder
attention pair over the steps and eval batches of the traced run's
profiled call (`jobs/p1_mtan.py`, `mtan_work.py`) over the device seconds
of its kernels in that call; None where the run read none."""


def read(run):
    profile = run.profile or {}
    if run.readings.get("tag") != "p1" or not profile.get("mtan_attn_s"):
        return None
    return 100.0 * run.readings["mtan_attn_bound_s"] / profile["mtan_attn_s"]
