"""The reference reports no capacity fills."""


def report(name, fill, capacity) -> None:
    return None
