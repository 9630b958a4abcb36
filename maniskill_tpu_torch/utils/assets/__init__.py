from .data import ASSET_DIR, DATA_GROUPS, DATA_SOURCES, DataSource, register_data_source
