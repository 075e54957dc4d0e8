# -*- coding: utf-8 -*-
# Generated by hack/gen_topology_pb2.py (no protoc in this image).
# source: topology.proto — DO NOT EDIT BY HAND; edit the proto and rerun.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0etopology.proto\x12\x17dragonfly2_tpu.topology"Q\n\rEstRttRequest\x12\x1e\n\x0bsrc_host_id\x18\x01 \x01(\tR\tsrcHostId\x12 \n\x0cdest_host_id\x18\x02 \x01(\tR\ndestHostId"U\n\x0eEstRttResponse\x12\x14\n\x05found\x18\x01 \x01(\x08R\x05found\x12\x15\n\x06rtt_ns\x18\x02 \x01(\x03R\x05rttNs\x12\x16\n\x06source\x18\x03 \x01(\tR\x06source"A\n\x10NeighborsRequest\x12\x17\n\x07host_id\x18\x01 \x01(\tR\x06hostId\x12\x14\n\x05limit\x18\x02 \x01(\x05R\x05limit"V\n\x08Neighbor\x12\x17\n\x07host_id\x18\x01 \x01(\tR\x06hostId\x12\x1c\n\navg_rtt_ns\x18\x02 \x01(\x03R\x08avgRttNs\x12\x13\n\x05age_s\x18\x03 \x01(\x01R\x04ageS"T\n\x11NeighborsResponse\x12?\n\tneighbors\x18\x01 \x03(\x0b2!.dragonfly2_tpu.topology.NeighborR\tneighbors"\x0e\n\x0cStatsRequest"\xfc\x01\n\rStatsResponse\x12\x14\n\x05hosts\x18\x01 \x01(\x03R\x05hosts\x12\x14\n\x05edges\x18\x02 \x01(\x03R\x05edges\x12%\n\x0epending_deltas\x18\x03 \x01(\x03R\rpendingDeltas\x12\x18\n\x07flushes\x18\x04 \x01(\x03R\x07flushes\x12\x1c\n\tlandmarks\x18\x05 \x01(\x03R\tlandmarks\x12$\n\x0ecache_hit_rate\x18\x06 \x01(\x01R\x0ccacheHitRate\x12\x18\n\x07backend\x18\x07 \x01(\tR\x07backend\x12 \n\x0cquery_p50_ms\x18\x08 \x01(\x01R\nqueryP50Ms2\xa1\x02\n\x08Topology\x12Y\n\x06EstRtt\x12&.dragonfly2_tpu.topology.EstRttRequest\x1a\'.dragonfly2_tpu.topology.EstRttResponse\x12b\n\tNeighbors\x12).dragonfly2_tpu.topology.NeighborsRequest\x1a*.dragonfly2_tpu.topology.NeighborsResponse\x12V\n\x05Stats\x12%.dragonfly2_tpu.topology.StatsRequest\x1a&.dragonfly2_tpu.topology.StatsResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'topology_pb2', globals())
