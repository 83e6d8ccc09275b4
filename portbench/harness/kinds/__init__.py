"""One driver a kind of traffic."""
