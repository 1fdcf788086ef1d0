"""Applications: the capture generator (``file_gen``) and scanner
(``file_scan``), the multi-carrier cell scanner (``scanner``), the
streaming scanner (``stream_scan``), the recorder and the ctrl socket."""
