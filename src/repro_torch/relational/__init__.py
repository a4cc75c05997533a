"""Static-shape masked tables and the relational operators over them."""
