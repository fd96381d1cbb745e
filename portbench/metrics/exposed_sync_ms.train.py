"""exposed_sync_ms.train: device wall ms a step from the end of the last
kernel launched in backward to the start of the first launched in
``optimizer.update``, idle included: the sync the step waits for
(``phases``)."""

from portbench import phases


def read(window, ctx):
    w = phases.window_for(window, ctx)
    if w is None:
        return None
    s = w.exposed_sync_s()
    return None if s is None else 1e3 * s
