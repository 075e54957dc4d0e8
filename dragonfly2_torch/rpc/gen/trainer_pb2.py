# -*- coding: utf-8 -*-
# Generated by hack/gen_trainer_pb2.py (no protoc in this image).
# source: trainer.proto — DO NOT EDIT BY HAND; edit the proto and rerun.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rtrainer.proto\x12\x16dragonfly2_tpu.trainer"+\n\x0fTrainMlpRequest\x12\x18\n\x07dataset\x18\x01 \x01(\x0cR\x07dataset"+\n\x0fTrainGnnRequest\x12\x18\n\x07dataset\x18\x01 \x01(\x0cR\x07dataset"1\n\x15TrainMlpBinaryRequest\x12\x18\n\x07dataset\x18\x01 \x01(\x0cR\x07dataset"1\n\x15TrainGnnBinaryRequest\x12\x18\n\x07dataset\x18\x01 \x01(\x0cR\x07dataset"\xaa\x03\n\x0cTrainRequest\x12\x0e\n\x02ip\x18\x01 \x01(\tR\x02ip\x12\x1a\n\x08hostname\x18\x02 \x01(\tR\x08hostname\x12\x1d\n\ncluster_id\x18\x03 \x01(\tR\tclusterId\x12F\n\ttrain_mlp\x18\n \x01(\x0b2\'.dragonfly2_tpu.trainer.TrainMlpRequestH\x00R\x08trainMlp\x12F\n\ttrain_gnn\x18\x0b \x01(\x0b2\'.dragonfly2_tpu.trainer.TrainGnnRequestH\x00R\x08trainGnn\x12Y\n\x10train_mlp_binary\x18\x0c \x01(\x0b2-.dragonfly2_tpu.trainer.TrainMlpBinaryRequestH\x00R\x0etrainMlpBinary\x12Y\n\x10train_gnn_binary\x18\r \x01(\x0b2-.dragonfly2_tpu.trainer.TrainGnnBinaryRequestH\x00R\x0etrainGnnBinaryB\t\n\x07request"\x0f\n\rTrainResponse"\x15\n\x13CapabilitiesRequest";\n\x14CapabilitiesResponse\x12#\n\rtrain_formats\x18\x01 \x03(\tR\x0ctrainFormats2\xcc\x01\n\x07Trainer\x12V\n\x05Train\x12$.dragonfly2_tpu.trainer.TrainRequest\x1a%.dragonfly2_tpu.trainer.TrainResponse(\x01\x12i\n\x0cCapabilities\x12+.dragonfly2_tpu.trainer.CapabilitiesRequest\x1a,.dragonfly2_tpu.trainer.CapabilitiesResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'trainer_pb2', globals())
