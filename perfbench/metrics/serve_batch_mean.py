"""Images per device call of the batcher over the window, from its
``stats()`` counters read before and after."""


def read(run):
    batches = run.counters.get("batches_served")
    return run.counters["images_served"] / batches if batches else None
