"""The mesh and the serving plane: the leader's device step data-parallel
over the cards (mesh.py), the shard router (router.py), and the plane with
its pipeline stage (serve.py)."""
