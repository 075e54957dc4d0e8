"""Client plane: peer daemon (piece store, P2P piece pipeline, upload
server, gRPC surface, registry proxy over the P2P transport) + thin CLIs
(dfget/dfcache) — counterpart of the reference's ``client/`` package, its
download path and its registry proxy. Two parts are not ported yet
(ROADMAP queue A item A-D2): the cloud source clients (a) and the object
storage gateway with dfstore (b).

Role parity: upstream client/ tree — daemon assembly
(client/daemon/daemon.go), conductor hot path
(client/daemon/peer/peertask_conductor.go), piece disk store
(client/daemon/storage/storage_manager.go), upload server
(client/daemon/upload/upload_manager.go), CLIs (client/dfget,
client/dfcache, client/dfstore), registry proxy
(client/daemon/proxy/proxy.go, client/daemon/transport/transport.go).
"""
