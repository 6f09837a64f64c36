"""Scale-out: the local (data x model) grid with the hash-range sharded
index (mesh.py), and reads range-sharded over processes on several hosts
(distributed.py)."""
