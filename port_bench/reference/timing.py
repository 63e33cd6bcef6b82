"""The reference marks no stages."""


def mark(name: str) -> None:
    return None
