"""Host time per step waiting for the next batch from the data pipeline
(the device iterator's ``next``), over the window; none where the feed is
batches already in memory."""


def read(run):
    if run.cell.traffic.get("feed") != "pipeline":
        return None
    return run.spans.mean_ms("data_wait")
