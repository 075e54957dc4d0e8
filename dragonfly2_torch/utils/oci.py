"""OCI registry dialect constants — ONE home for the manifest media
types, shared by the preheat job (scheduler/job.py image resolution) and
the oras back-to-source client (client/source_cloud.py): a new media
type or Accept tweak lands in both consumers at once."""

MANIFEST_TYPE_OCI = "application/vnd.oci.image.manifest.v1+json"
MANIFEST_TYPE_DOCKER = "application/vnd.docker.distribution.manifest.v2+json"
INDEX_TYPE_OCI = "application/vnd.oci.image.index.v1+json"
INDEX_TYPE_DOCKER = "application/vnd.docker.distribution.manifest.list.v2+json"

INDEX_TYPES = (INDEX_TYPE_DOCKER, INDEX_TYPE_OCI)

# single manifests only (artifact pulls — the oras client)
MANIFEST_ACCEPT = ", ".join((MANIFEST_TYPE_OCI, MANIFEST_TYPE_DOCKER))
# manifests + multi-arch indexes (image preheat resolution)
MANIFEST_OR_INDEX_ACCEPT = ", ".join(
    (MANIFEST_TYPE_DOCKER, MANIFEST_TYPE_OCI, *INDEX_TYPES)
)
