# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: onnx_subset.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x11onnx_subset.proto\x12\thawq_onnx\"\xf0\x02\n\x0e\x41ttributeProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\t\n\x01\x66\x18\x02 \x01(\x02\x12\t\n\x01i\x18\x03 \x01(\x03\x12\t\n\x01s\x18\x04 \x01(\x0c\x12!\n\x01t\x18\x05 \x01(\x0b\x32\x16.hawq_onnx.TensorProto\x12\x0e\n\x06\x66loats\x18\x07 \x03(\x02\x12\x0c\n\x04ints\x18\x08 \x03(\x03\x12\x0f\n\x07strings\x18\t \x03(\x0c\x12\x12\n\ndoc_string\x18\r \x01(\t\x12\x35\n\x04type\x18\x14 \x01(\x0e\x32\'.hawq_onnx.AttributeProto.AttributeType\"\x91\x01\n\rAttributeType\x12\r\n\tUNDEFINED\x10\x00\x12\t\n\x05\x46LOAT\x10\x01\x12\x07\n\x03INT\x10\x02\x12\n\n\x06STRING\x10\x03\x12\n\n\x06TENSOR\x10\x04\x12\t\n\x05GRAPH\x10\x05\x12\n\n\x06\x46LOATS\x10\x06\x12\x08\n\x04INTS\x10\x07\x12\x0b\n\x07STRINGS\x10\x08\x12\x0b\n\x07TENSORS\x10\t\x12\n\n\x06GRAPHS\x10\n\"V\n\x0eValueInfoProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\"\n\x04type\x18\x02 \x01(\x0b\x32\x14.hawq_onnx.TypeProto\x12\x12\n\ndoc_string\x18\x03 \x01(\t\"\x9b\x01\n\tNodeProto\x12\r\n\x05input\x18\x01 \x03(\t\x12\x0e\n\x06output\x18\x02 \x03(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x0f\n\x07op_type\x18\x04 \x01(\t\x12,\n\tattribute\x18\x05 \x03(\x0b\x32\x19.hawq_onnx.AttributeProto\x12\x12\n\ndoc_string\x18\x06 \x01(\t\x12\x0e\n\x06\x64omain\x18\x07 \x01(\t\"\xe7\x01\n\nModelProto\x12\x12\n\nir_version\x18\x01 \x01(\x03\x12\x15\n\rproducer_name\x18\x02 \x01(\t\x12\x18\n\x10producer_version\x18\x03 \x01(\t\x12\x0e\n\x06\x64omain\x18\x04 \x01(\t\x12\x15\n\rmodel_version\x18\x05 \x01(\x03\x12\x12\n\ndoc_string\x18\x06 \x01(\t\x12$\n\x05graph\x18\x07 \x01(\x0b\x32\x15.hawq_onnx.GraphProto\x12\x33\n\x0copset_import\x18\x08 \x03(\x0b\x32\x1d.hawq_onnx.OperatorSetIdProto\"\x83\x02\n\nGraphProto\x12\"\n\x04node\x18\x01 \x03(\x0b\x32\x14.hawq_onnx.NodeProto\x12\x0c\n\x04name\x18\x02 \x01(\t\x12+\n\x0binitializer\x18\x05 \x03(\x0b\x32\x16.hawq_onnx.TensorProto\x12\x12\n\ndoc_string\x18\n \x01(\t\x12(\n\x05input\x18\x0b \x03(\x0b\x32\x19.hawq_onnx.ValueInfoProto\x12)\n\x06output\x18\x0c \x03(\x0b\x32\x19.hawq_onnx.ValueInfoProto\x12-\n\nvalue_info\x18\r \x03(\x0b\x32\x19.hawq_onnx.ValueInfoProto\"\xe3\x02\n\x0bTensorProto\x12\x0c\n\x04\x64ims\x18\x01 \x03(\x03\x12\x11\n\tdata_type\x18\x02 \x01(\x05\x12\x12\n\nfloat_data\x18\x04 \x03(\x02\x12\x12\n\nint32_data\x18\x05 \x03(\x05\x12\x13\n\x0bstring_data\x18\x06 \x03(\x0c\x12\x12\n\nint64_data\x18\x07 \x03(\x03\x12\x0c\n\x04name\x18\x08 \x01(\t\x12\x10\n\x08raw_data\x18\t \x01(\x0c\x12\x12\n\ndoc_string\x18\x0c \x01(\t\"\xad\x01\n\x08\x44\x61taType\x12\r\n\tUNDEFINED\x10\x00\x12\t\n\x05\x46LOAT\x10\x01\x12\t\n\x05UINT8\x10\x02\x12\x08\n\x04INT8\x10\x03\x12\n\n\x06UINT16\x10\x04\x12\t\n\x05INT16\x10\x05\x12\t\n\x05INT32\x10\x06\x12\t\n\x05INT64\x10\x07\x12\n\n\x06STRING\x10\x08\x12\x08\n\x04\x42OOL\x10\t\x12\x0b\n\x07\x46LOAT16\x10\n\x12\n\n\x06\x44OUBLE\x10\x0b\x12\n\n\x06UINT32\x10\x0c\x12\n\n\x06UINT64\x10\r\"\x86\x01\n\tTypeProto\x12\x30\n\x0btensor_type\x18\x01 \x01(\x0b\x32\x1b.hawq_onnx.TypeProto.Tensor\x1aG\n\x06Tensor\x12\x11\n\telem_type\x18\x01 \x01(\x05\x12*\n\x05shape\x18\x02 \x01(\x0b\x32\x1b.hawq_onnx.TensorShapeProto\"\x86\x01\n\x10TensorShapeProto\x12\x32\n\x03\x64im\x18\x01 \x03(\x0b\x32%.hawq_onnx.TensorShapeProto.Dimension\x1a>\n\tDimension\x12\x13\n\tdim_value\x18\x01 \x01(\x03H\x00\x12\x13\n\tdim_param\x18\x02 \x01(\tH\x00\x42\x07\n\x05value\"5\n\x12OperatorSetIdProto\x12\x0e\n\x06\x64omain\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'onnx_subset_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ATTRIBUTEPROTO._serialized_start=33
  _ATTRIBUTEPROTO._serialized_end=401
  _ATTRIBUTEPROTO_ATTRIBUTETYPE._serialized_start=256
  _ATTRIBUTEPROTO_ATTRIBUTETYPE._serialized_end=401
  _VALUEINFOPROTO._serialized_start=403
  _VALUEINFOPROTO._serialized_end=489
  _NODEPROTO._serialized_start=492
  _NODEPROTO._serialized_end=647
  _MODELPROTO._serialized_start=650
  _MODELPROTO._serialized_end=881
  _GRAPHPROTO._serialized_start=884
  _GRAPHPROTO._serialized_end=1143
  _TENSORPROTO._serialized_start=1146
  _TENSORPROTO._serialized_end=1501
  _TENSORPROTO_DATATYPE._serialized_start=1328
  _TENSORPROTO_DATATYPE._serialized_end=1501
  _TYPEPROTO._serialized_start=1504
  _TYPEPROTO._serialized_end=1638
  _TYPEPROTO_TENSOR._serialized_start=1567
  _TYPEPROTO_TENSOR._serialized_end=1638
  _TENSORSHAPEPROTO._serialized_start=1641
  _TENSORSHAPEPROTO._serialized_end=1775
  _TENSORSHAPEPROTO_DIMENSION._serialized_start=1713
  _TENSORSHAPEPROTO_DIMENSION._serialized_end=1775
  _OPERATORSETIDPROTO._serialized_start=1777
  _OPERATORSETIDPROTO._serialized_end=1830
# @@protoc_insertion_point(module_scope)
