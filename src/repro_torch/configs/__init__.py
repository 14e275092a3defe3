"""Architecture configurations the port can run (yi-6b and its reduced form)."""
