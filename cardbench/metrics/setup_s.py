"""Process start to the first timed request: the node's build, warm-up
and compile, the workers' start, the fill and the warm-up phase."""


def read(record: dict) -> float:
    return record["setup_s"]
