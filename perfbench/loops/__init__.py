"""One generator per loop kind; a traffic file's `loop` names it."""
