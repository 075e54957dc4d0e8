"""Client plane: peer daemon (piece store, P2P piece pipeline, upload
server, gRPC surface) + thin CLIs (dfget/dfcache) — counterpart of the
reference's ``client/`` package, its download path. The proxy, the object
storage gateway, dfstore and the cloud source clients are not ported yet
(ROADMAP queue A item A-D2).

Role parity: upstream client/ tree — daemon assembly
(client/daemon/daemon.go), conductor hot path
(client/daemon/peer/peertask_conductor.go), piece disk store
(client/daemon/storage/storage_manager.go), upload server
(client/daemon/upload/upload_manager.go), CLIs (client/dfget,
client/dfcache, client/dfstore).
"""
