"""The 95th percentile, over every pod submitted and bound in the window,
of its bind's stamp less the moment its gang was handed to the store."""

from benchmark.readers import percentile


def read(run):
    submitted = {g for c in run.cycles for g in c.submitted}
    lat = []
    for _, key, _, t in run.binds:
        gang = key.split("/", 1)[1].rsplit("-", 1)[0]
        if gang in submitted:
            lat.append((t - run.submit_t[gang]) * 1e3)
    return percentile(lat, 95)
