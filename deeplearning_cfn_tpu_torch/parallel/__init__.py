"""The parallelism surface of the port: meshes, sharding rules and the
collectives the model and the trainer call."""
