"""etl subpackage."""
