"""The evidence pool (reference evidence/)."""
