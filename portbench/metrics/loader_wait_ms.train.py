"""Mean ms the loop waits for the loader's next batch in the window (the
harness's span around ``next``)."""


def read(run):
    waits = run.get("waits")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
