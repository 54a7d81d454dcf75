"""One runner per traffic kind, found by the traffic file's ``kind``."""
