"""One driver per file: the loop a cell's window runs, found by the traffic file's ``driver``."""
