"""Client plane: peer daemon (piece store, P2P piece pipeline, upload
server, gRPC surface, registry proxy and object-storage gateway over the
P2P transport) + thin CLIs (dfget/dfcache/dfstore) and the back-to-source
clients (http(s), file, s3, oss, hdfs, oras) — counterpart of the
reference's ``client/`` package.

Role parity: upstream client/ tree — daemon assembly
(client/daemon/daemon.go), conductor hot path
(client/daemon/peer/peertask_conductor.go), piece disk store
(client/daemon/storage/storage_manager.go), upload server
(client/daemon/upload/upload_manager.go), CLIs (client/dfget,
client/dfcache, client/dfstore), registry proxy
(client/daemon/proxy/proxy.go, client/daemon/transport/transport.go),
object-storage gateway (client/daemon/objectstorage/objectstorage.go),
source clients (pkg/source/clients/).
"""
