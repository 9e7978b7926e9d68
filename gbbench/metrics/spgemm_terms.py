"""Terms of the sparse products per traced trial, as the program's
``spgemm:<formulation>:terms=<t>:gustavson=<g>:dot=<d>`` ranges name them
(the masked dot's or Gustavson's expansion, whichever ran)."""


def terms(name):
    parts = name.split(":")
    if len(parts) != 5 or parts[0] != "spgemm" or \
            not parts[2].startswith("terms="):
        return None
    return int(parts[2].split("=", 1)[1])


def read(run):
    if run.trace is None:
        return None
    counts = [t for t in (terms(name) for _, _, name in run.trace.ranges)
              if t is not None]
    return sum(counts) / run.traced_trials if counts else None
