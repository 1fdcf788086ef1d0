"""Applications: the capture scanner (``file_scan``) and the
multi-carrier cell scanner (``scanner``)."""
