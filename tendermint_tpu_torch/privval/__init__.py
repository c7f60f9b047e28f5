"""The file-backed private validator (reference privval/)."""
