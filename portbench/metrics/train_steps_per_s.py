"""Full (G, adv, D) steps completed in the window over its seconds; the
window closes once the card has finished the last step."""


def read(run):
    if "steps" not in run:
        return None
    return run["steps"] / run["seconds"]
