"""`mtan_attn_share.p1`: % of the traced run's profiled call's busy device
seconds in mTAN's encoder attention kernels (`jobs/p1_mtan.py`); None where
the run read none."""


def read(run):
    profile = run.profile or {}
    if run.readings.get("tag") != "p1" or not profile.get("mtan_attn_s") \
            or not profile.get("busy_s"):
        return None
    return 100.0 * profile["mtan_attn_s"] / profile["busy_s"]
